// Kernel K1: the block SpMM, out[num_nodes, d] = A @ feat, over the binned
// block-CSR plan of voltrix_spmm_tpu_torch/format/plan.py, for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_block_kernel together
// with the row gather it consumes there (_gather_rows, a jnp.take). The TPU
// kernel walks a sequential grid and revisits a window's output tile while
// the window is unchanged; blocks on Hopper run in parallel and in no
// order, so here each thread block owns its output rows outright and walks
// the window's blocks in a loop.
//
// Design. One thread block per (window w, 32-row word wi, 32-column feature
// chunk). Lane l of every warp owns feature column chunk*32 + l and 32 fp32
// sums in registers, one per window row 32*wi + s. The window's work is cut
// into units, one per (block, 32-lane slice of the block), dealt out to the
// kGroups warps round robin; each warp loads its next unit's bitmask words
// and hind (coalesced) while it works on the current one. For a unit, a
// ballot compacts the lanes whose word has a bit, in lane order, into the
// warp's slice of shared memory; then for each such lane the warp adds
// X[hind, col] into the sums of the word's set bits. The word is the same
// for the whole warp, so the bit tests do not diverge. The warps' sums are
// added in a fixed tree order at the end, so the result is deterministic.
// The gather is fused: no (total_blocks * block_w, d) gathered array is
// materialised. A window with no blocks writes zeros. Lanes whose hind lies
// past the last source row (the tail of gather_segment > 1 plans) carry no
// bits and are skipped.
//
// Bound. On the H100 the kernel is bound by the instructions and load
// latency of one thread block: the one that owns the first word of the
// heaviest window. Per kept lane a warp issues one 128-byte load of an X
// row slice and a few instructions per set bit. On the ogbn-arxiv proxy at
// block_h 128 the first window holds 903 of the plan's 9,783 blocks (mean
// 7.4), and its first word 97,871 of the 1.41M kept (lane, word) pairs: that
// window alone takes about 80% of the d=128 SpMM time. Splitting a window's
// units over 16 warps shortens that path 16-fold within one SM; splitting
// it across SMs (load balance) is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 16;  // warps per thread block; a power of two
constexpr int kThreads = 32 * kGroups;
constexpr int kPrefetch = 8;  // kept lanes whose X values are loaded at once

__global__ void __launch_bounds__(kThreads)
spmm_block_kernel(const uint32_t* __restrict__ bitmask,   // (B, words, block_w)
                  const int32_t* __restrict__ hind,       // (B, block_w)
                  const int32_t* __restrict__ block_ptr,  // (num_windows + 1)
                  const float* __restrict__ feat,         // (source_rows, d)
                  float* __restrict__ out,                // (num_nodes, d)
                  int words, int block_h, int block_w, int num_nodes,
                  int source_rows, int d) {
  __shared__ uint32_t s_word[kGroups][32];
  __shared__ int32_t s_src[kGroups][32];
  __shared__ float s_red[kGroups / 2][32][32];

  const int w = blockIdx.x;
  const int wi = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.z * 32 + lane;
  const bool col_ok = col < d;

  float acc[32];
#pragma unroll
  for (int s = 0; s < 32; ++s) acc[s] = 0.f;

  const int slices = (block_w + 31) / 32;
  const int b_begin = block_ptr[w];
  const int units = (block_ptr[w + 1] - b_begin) * slices;
  // unit u is lane slice u % slices of block b_begin + u / slices
  auto load_unit = [&](int u, uint32_t& word_out, int32_t& src_out) {
    word_out = 0u;
    src_out = 0;
    if (u < units) {
      const int64_t b = b_begin + u / slices;
      const int j = (u % slices) * 32 + lane;
      if (j < block_w) {
        word_out = bitmask[(b * words + wi) * block_w + j];
        src_out = hind[b * block_w + j];
      }
    }
  };
  uint32_t word, next_word;
  int32_t src, next_src;
  load_unit(warp, word, src);
  for (int u = warp; u < units; u += kGroups) {
    load_unit(u + kGroups, next_word, next_src);
    const bool keep = word != 0u && src >= 0 && src < source_rows;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = __popc(ballot & ((1u << lane) - 1u));
      s_word[warp][pos] = word;
      s_src[warp][pos] = src;
    }
    __syncwarp();
    const int total = __popc(ballot);
    if (col_ok) {
      for (int p = 0; p < total; p += kPrefetch) {
        float x[kPrefetch];
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) {
          x[q] = p + q < total ? feat[(int64_t)s_src[warp][p + q] * d + col] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) {
          const uint32_t m = p + q < total ? s_word[warp][p + q] : 0u;
          // constant indices keep acc in registers; a zero byte skips 8 bits
#pragma unroll
          for (int byte = 0; byte < 4; ++byte) {
            if ((m >> (8 * byte)) & 0xffu) {
#pragma unroll
              for (int s = 8 * byte; s < 8 * byte + 8; ++s) {
                if ((m >> s) & 1u) acc[s] += x[q];
              }
            }
          }
        }
      }
    }
    __syncwarp();  // s_word and s_src are reused
    word = next_word;
    src = next_src;
  }

  // warp g + h adds into warp g, halving h each step: a fixed order
  for (int h = kGroups / 2; h > 0; h /= 2) {
    __syncthreads();
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int s = 0; s < 32; ++s) s_red[warp - h][s][lane] = acc[s];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int s = 0; s < 32; ++s) acc[s] += s_red[warp][s][lane];
    }
  }

  if (warp != 0 || !col_ok) return;
  const int64_t row0 = (int64_t)w * block_h + 32 * wi;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    if (32 * wi + s < block_h && row0 + s < num_nodes) {
      out[(row0 + s) * d + col] = acc[s];
    }
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` and returns cudaGetLastError() as an int (0 on
// success). All pointers are device pointers; `bitmask` holds uint32 words.
int voltrix_spmm_block_f32(const void* bitmask, const void* hind,
                           const void* block_ptr, const void* feat, void* out,
                           int num_windows, int words, int block_h,
                           int block_w, int num_nodes, int source_rows, int d,
                           void* stream) {
  const dim3 grid(num_windows, words, (d + 31) / 32);
  spmm_block_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(block_ptr), static_cast<const float*>(feat),
      static_cast<float*>(out), words, block_h, block_w, num_nodes, source_rows,
      d);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

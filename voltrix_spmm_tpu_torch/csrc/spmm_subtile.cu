// Kernel K2: the sub-window-skipping SpMM, out[num_nodes, d] = A @ feat, over
// the binned block-CSR plan with a per-block occupancy bitmap, for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_subtiled_kernel together
// with the row gather it consumes there. The TPU kernel expands and multiplies
// only the 128-row sub-windows whose occupancy bit is set, ORed over each
// unroll group so its MXU dots stay wide. Here the skip is per block: bit
// s of occ[b] is set iff sub-window s of block b holds a bit (format/cluster.py
// block_occupancy, or the wrapper computes it from the bitmask), so a block
// whose bit is clear carries no bits in those rows, and skipping it gives the
// same sums as the group skip, with fewer blocks visited.
//
// Design. K1's design (csrc/spmm_block.cu) with the skip added. One thread
// block per (window w, 32-row word wi, 32-column feature chunk); lane l of
// every warp owns column chunk*32 + l of the word's 32 rows, whose fp32 sums
// live in the warp's own slice of shared memory. The window's (block,
// 32-lane slice) units are dealt to kGroups warps round robin. Before a
// warp loads a unit's bitmask word and hind, it reads occ[b] (one broadcast
// load) and tests bit wi / 4, the unit's sub-window; a clear bit makes the
// unit empty without touching the bitmask or X. A ballot compacts the lanes
// whose word has a bit; the warp loads their X values 8 at a time and, for
// each, walks the word's set bits with __ffs, adding X[hind, col] into that
// row's sum (the word is the same across the warp, so the walk does not
// diverge). The warps' sums are added in a fixed tree order, so the result
// is deterministic. The gather is fused: nothing of xg is materialised. A
// window with no blocks writes zeros.
//
// Grid order. blockIdx.x enumerates (window, word) with the word fastest, so
// the words of one window run side by side and read the same X rows (the
// window's lanes) while they are in L2; blockIdx.y is the column chunk. The
// x dimension holds num_windows * words up to 2^31 - 1.
//
// Bound. As K1: the instructions and load latency of the thread block that
// owns the heaviest word of the heaviest window. On the ogbn-arxiv proxy at
// block_h 2048 the first window holds 1,100 of 5,696 blocks, and its first
// word carries the hub rows, so that one thread block walks 4,400 units
// while the mean window has 274; the skip removes the units of other
// sub-windows, not that path. The __ffs walk into shared memory took
// 0.91x / 0.86x the time of K1's register sums with a byte-skipping bit loop
// on this plan at d=128 / d=256.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 16;  // warps per thread block; a power of two
constexpr int kThreads = 32 * kGroups;
constexpr int kPrefetch = 8;  // kept lanes whose X values are loaded at once
constexpr int kSumFloats = 32 * 32;  // a warp's 32 rows x 32 columns of sums
constexpr int kSmemBytes = kGroups * kSumFloats * sizeof(float);  // 64 KB

__global__ void __launch_bounds__(kThreads)
spmm_subtile_kernel(const uint32_t* __restrict__ bitmask,   // (B, words, block_w)
                    const int32_t* __restrict__ hind,       // (B, block_w)
                    const int32_t* __restrict__ block_ptr,  // (num_windows + 1)
                    const uint32_t* __restrict__ occ,       // (B,) sub-window bits
                    const float* __restrict__ feat,         // (source_rows, d)
                    float* __restrict__ out,                // (num_nodes, d)
                    int words, int block_h, int block_w, int num_nodes,
                    int source_rows, int d) {
  extern __shared__ float s_sum[];  // (kGroups, 32 rows, 32 columns)
  __shared__ uint32_t s_word[kGroups][32];
  __shared__ int32_t s_src[kGroups][32];

  const int w = blockIdx.x / words;
  const int wi = blockIdx.x % words;
  const uint32_t sub_bit = 1u << (wi / 4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.y * 32 + lane;
  const bool col_ok = col < d;

  // row s of this warp's sums, column lane: only this lane touches it
  // until the reduction
  float* acc = s_sum + warp * kSumFloats + lane;
#pragma unroll
  for (int s = 0; s < 32; ++s) acc[32 * s] = 0.f;

  const int slices = (block_w + 31) / 32;
  const int b_begin = block_ptr[w];
  const int units = (block_ptr[w + 1] - b_begin) * slices;
  // unit u is lane slice u % slices of block b_begin + u / slices; a unit
  // whose block has no bit in this word's sub-window loads nothing more
  auto load_unit = [&](int u, uint32_t& word_out, int32_t& src_out) {
    word_out = 0u;
    src_out = 0;
    if (u < units) {
      const int64_t b = b_begin + u / slices;
      const int j = (u % slices) * 32 + lane;
      if ((occ[b] & sub_bit) && j < block_w) {
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
    if (ballot != 0u) {
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
            // the word is the same across the warp: a uniform walk of its bits
            uint32_t m = p + q < total ? s_word[warp][p + q] : 0u;
            while (m) {
              acc[32 * (__ffs(m) - 1)] += x[q];
              m &= m - 1;
            }
          }
        }
      }
      __syncwarp();  // s_word and s_src are reused
    }
    word = next_word;
    src = next_src;
  }

  // warp g + h adds into warp g, halving h each step: a fixed order
  for (int h = kGroups / 2; h > 0; h /= 2) {
    __syncthreads();
    if (warp < h) {
      const float* other = acc + h * kSumFloats;
#pragma unroll
      for (int s = 0; s < 32; ++s) acc[32 * s] += other[32 * s];
    }
  }

  if (warp != 0 || !col_ok) return;
  const int64_t row0 = (int64_t)w * block_h + 32 * wi;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    if (row0 + s < num_nodes) out[(row0 + s) * d + col] = acc[32 * s];
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream` and returns the first CUDA error as an int (0 on
// success). All pointers are device pointers; `bitmask` and `occ` hold
// uint32 words. block_h is a multiple of 128.
int voltrix_spmm_subtile_f32(const void* bitmask, const void* hind,
                             const void* block_ptr, const void* occ,
                             const void* feat, void* out, int num_windows,
                             int words, int block_h, int block_w,
                             int num_nodes, int source_rows, int d,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spmm_subtile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_windows * words, (d + 31) / 32);
  spmm_subtile_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(block_ptr), static_cast<const uint32_t*>(occ),
      static_cast<const float*>(feat), static_cast<float*>(out), words, block_h,
      block_w, num_nodes, source_rows, d);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Kernel K8: the int8 SpMM, out[num_nodes, d] = A @ dequant(q, scale), over
// the binned block-CSR plan of voltrix_spmm_tpu_torch/format/plan.py, for
// sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/quant.py:_quant_kernel together with the two
// gathers it consumes there (the int8 rows and the per-row scales, each a
// jnp.take). The features arrive quantized per source row: q int8 (source_rows,
// d4) with d4 = d rounded up to a multiple of 4 (zero columns), and one
// float32 scale per row. The TPU kernel's arithmetic is kept exactly: each
// gathered value is bf16_rn(float(q) * float(bf16_rn(scale[src]))) (q is exact
// in bf16, and a product of two bf16 values is exact in float32, so the one
// rounding is the bf16 multiply's), and the sums are float32.
//
// Design: K1's (csrc/spmm_block.cu), with a thread block that owns 8 rows and
// 128 columns instead of 32 and 32. One thread block per (window w, byte of a
// 32-row word, 128-column chunk); lane l of every warp owns columns
// chunk*128 + 4l .. 4l+3 and reads them as one 32-bit load, so a warp reads a
// 128-byte row slice, and keeps 8 x 4 float32 sums. The window's units, one per
// (block, 32-lane slice), are dealt to the kGroups warps round robin as in K1;
// a ballot keeps the lanes whose byte of the word has a bit and compacts them,
// with their 8 row bits and source row, into the warp's shared memory. The
// gather and the dequantization are fused: no gathered array is materialised.
// The warps' sums are added in a fixed tree order, so the result is
// deterministic. A window with no blocks writes zeros; lanes past the last
// source row (the tail of gather_segment > 1 plans) carry no bits and are
// skipped.
//
// Bound. Like K1, by the walk of the heaviest window's units: every thread
// block of a window walks all of its units, and keeps only the lanes with a
// bit in its 8 rows.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 16;  // warps per thread block; a power of two
constexpr int kThreads = 32 * kGroups;
constexpr int kPrefetch = 8;  // kept lanes whose int8 values are loaded at once
constexpr int kCols = 128;    // columns per thread block, 4 per lane

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
spmm_int8_kernel(const uint32_t* __restrict__ bitmask,   // (B, words, block_w)
                 const int32_t* __restrict__ hind,       // (B, block_w)
                 const int32_t* __restrict__ block_ptr,  // (num_windows + 1)
                 const char4* __restrict__ q,            // (source_rows, d4 / 4)
                 const float* __restrict__ scale,        // (source_rows)
                 float* __restrict__ out,                // (num_nodes, d)
                 int words, int block_h, int block_w, int num_nodes,
                 int source_rows, int d, int d4) {
  __shared__ uint32_t s_bits[kGroups][32];
  __shared__ int32_t s_src[kGroups][32];
  __shared__ float s_red[kGroups / 2][32][32];

  const int w = blockIdx.x;
  const int wi = blockIdx.y / 4;
  const int byte = blockIdx.y % 4;
  const int row_in_window = 32 * wi + 8 * byte;
  if (row_in_window >= block_h) return;  // rows past block_h carry no bits
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.z * kCols + 4 * lane;
  const bool col_ok = col0 < d4;
  const int quads = d4 / 4;

  float acc[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[s][k] = 0.f;
  }

  const int slices = (block_w + 31) / 32;
  const int b_begin = block_ptr[w];
  const int units = (block_ptr[w + 1] - b_begin) * slices;
  // unit u is lane slice u % slices of block b_begin + u / slices
  auto load_unit = [&](int u, uint32_t& bits_out, int32_t& src_out) {
    bits_out = 0u;
    src_out = 0;
    if (u < units) {
      const int64_t b = b_begin + u / slices;
      const int j = (u % slices) * 32 + lane;
      if (j < block_w) {
        bits_out = (bitmask[(b * words + wi) * block_w + j] >> (8 * byte)) & 0xffu;
        src_out = hind[b * block_w + j];
      }
    }
  };
  uint32_t bits, next_bits;
  int32_t src, next_src;
  load_unit(warp, bits, src);
  for (int u = warp; u < units; u += kGroups) {
    load_unit(u + kGroups, next_bits, next_src);
    const bool keep = bits != 0u && src >= 0 && src < source_rows;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = __popc(ballot & ((1u << lane) - 1u));
      s_bits[warp][pos] = bits;
      s_src[warp][pos] = src;
    }
    __syncwarp();
    const int total = __popc(ballot);
    if (col_ok) {
      for (int p = 0; p < total; p += kPrefetch) {
        char4 x[kPrefetch];
        float sc[kPrefetch];
#pragma unroll
        for (int k = 0; k < kPrefetch; ++k) {
          x[k] = make_char4(0, 0, 0, 0);
          sc[k] = 0.f;
          if (p + k < total) {
            const int64_t r = s_src[warp][p + k];
            x[k] = q[r * quads + col0 / 4];
            sc[k] = scale[r];
          }
        }
#pragma unroll
        for (int k = 0; k < kPrefetch; ++k) {
          const uint32_t m = p + k < total ? s_bits[warp][p + k] : 0u;
          const float s_bf = bf16_round(sc[k]);
          const float v[4] = {bf16_round(static_cast<float>(x[k].x) * s_bf),
                              bf16_round(static_cast<float>(x[k].y) * s_bf),
                              bf16_round(static_cast<float>(x[k].z) * s_bf),
                              bf16_round(static_cast<float>(x[k].w) * s_bf)};
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            if ((m >> s) & 1u) {
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[s][c] += v[c];
            }
          }
        }
      }
    }
    __syncwarp();  // s_bits and s_src are reused
    bits = next_bits;
    src = next_src;
  }

  // warp g + h adds into warp g, halving h each step: a fixed order
  for (int h = kGroups / 2; h > 0; h /= 2) {
    __syncthreads();
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s_red[warp - h][4 * s + c][lane] = acc[s][c];
      }
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[s][c] += s_red[warp][4 * s + c][lane];
      }
    }
  }

  if (warp != 0 || !col_ok) return;
  const int64_t row0 = (int64_t)w * block_h + row_in_window;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (row_in_window + s < block_h && row0 + s < num_nodes) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col0 + c < d) out[(row0 + s) * d + col0 + c] = acc[s][c];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches K8 on `stream` and returns cudaGetLastError() as an int (0 on
// success). All pointers are device pointers; `bitmask` holds uint32 words,
// `q` int8 rows of d4 (a multiple of 4) bytes, 4-byte aligned.
int voltrix_spmm_int8(const void* bitmask, const void* hind,
                      const void* block_ptr, const void* q, const void* scale,
                      void* out, int num_windows, int words, int block_h,
                      int block_w, int num_nodes, int source_rows, int d,
                      int d4, void* stream) {
  const dim3 grid(num_windows, 4 * words, (d4 + kCols - 1) / kCols);
  spmm_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(block_ptr), static_cast<const char4*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), words,
      block_h, block_w, num_nodes, source_rows, d, d4);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

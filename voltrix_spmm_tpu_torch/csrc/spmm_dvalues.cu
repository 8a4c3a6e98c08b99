// Kernel K5: the value gradient of the weighted SpMM, and the SDDMM,
// dV[b, r, l] = bit(b, r, l) ? g[w * block_h + r, :] . feat[hind[b, l], :] : 0
// for every block b of window w, a dense float32 (total_blocks, block_h,
// block_w) plane, for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/weighted.py:_dvalues_kernel together with
// the row gather it consumes there (a jnp.take with mode="clip") and the
// zero padding of g past num_nodes. The TPU sums the dot over feature
// chunks in a sequential grid dimension that revisits the output tile; here
// one thread block owns a plan block outright and loops over the chunks.
//
// Design. One thread block of 256 threads per plan block. Thread t owns
// lane l = t % block_w and the rows t / block_w + i * (256 / block_w) of a
// pass of up to 32 rows per thread (block_h 64 at block_w 128: one pass).
// The lanes' source rows are staged first; then for each chunk of 32
// feature columns the block stages the pass's rows of g and the block_w
// gathered rows of feat in shared memory, every load of a stage
// independent of the others (feat rows padded to 33 floats, so a warp's
// 32 lanes read 32 banks). Each thread adds 4 columns at a time: one
// float4 of its g row (the same row for the whole warp, a broadcast)
// against 4 lane values. The mask is applied on
// the store: a clear bit writes exactly 0.0, so the edge-slot scatter back
// to per-edge gradients is exact. Stores run along lanes, 128 bytes a warp.
//
// Bound. At the GAT widths (d = 8 and 40, block 64 x 128) the kernel writes
// the whole plane, 32 KB per block (416 MB on the ogbn-arxiv proxy), and
// computes 2 * 64 * 128 * d flops of which only the set bits are kept: it
// is bound by device memory, the write of the plane. The bitmask (1 KB per
// block) and the staged rows are the rest of its traffic.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // feature columns per staged chunk
constexpr int kAcc = 32;   // rows per thread per pass
constexpr int kMaxLanes = 256;
constexpr int kMaxPassRows = kAcc * kThreads / 128;  // block_w >= 128

__global__ void __launch_bounds__(kThreads)
spmm_dvalues_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                    const int32_t* __restrict__ hind,      // (B, K)
                    const int32_t* __restrict__ wob,       // (B,)
                    const float* __restrict__ feat,        // (source_rows, d)
                    const float* __restrict__ g,           // (num_nodes, d)
                    float* __restrict__ dv,                // (B, H, K)
                    int words, int block_h, int block_w, int num_nodes,
                    int source_rows, int d) {
  __shared__ __align__(16) float s_g[kMaxPassRows][kCols];
  __shared__ float s_x[kMaxLanes][kCols + 1];
  __shared__ int s_h[kMaxLanes];  // the lanes' source rows

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int l = t % block_w;
  const int r0 = t / block_w;
  const int rstep = kThreads / block_w;
  const int pass_rows = kAcc * rstep;
  const int64_t g_row0 = (int64_t)wob[b] * block_h;
  // staging: thread t copies column t % kCols of rows (or lanes) t / kCols
  // + j * kStage; every load of a stage is independent of the others
  const int sc = t % kCols;
  const int s0 = t / kCols;
  constexpr int kStage = kThreads / kCols;

  for (int i = t; i < block_w; i += kThreads) {
    const int src = hind[b * block_w + i];
    s_h[i] = min(max(src, 0), source_rows - 1);  // jnp.take(mode="clip")
  }
  __syncthreads();

  for (int p0 = 0; p0 < block_h; p0 += pass_rows) {
    const int rows = min(pass_rows, block_h - p0);
    // a pass spans at most 64 rows from a word boundary: two bitmask words
    // per lane, loaded with the first stage
    const int64_t w0 = (b * words + p0 / 32) * block_w + l;
    const uint32_t bits0 = bitmask[w0];
    const uint32_t bits1 = rows > 32 ? bitmask[w0 + block_w] : 0u;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    for (int c0 = 0; c0 < d; c0 += kCols) {
      const bool col_ok = c0 + sc < d;
#pragma unroll 8
      for (int r = s0; r < rows; r += kStage) {
        const int64_t row = g_row0 + p0 + r;
        s_g[r][sc] = (row < num_nodes && col_ok) ? g[row * d + c0 + sc] : 0.f;
      }
#pragma unroll 8
      for (int lane = s0; lane < block_w; lane += kStage) {
        s_x[lane][sc] = col_ok ? feat[(int64_t)s_h[lane] * d + c0 + sc] : 0.f;
      }
      __syncthreads();
      const int cols = min(kCols, d - c0);
      for (int c = 0; c < cols; c += 4) {
        const float x0 = s_x[l][c], x1 = s_x[l][c + 1];
        const float x2 = s_x[l][c + 2], x3 = s_x[l][c + 3];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int r = r0 + i * rstep;
          if (r < rows) {
            const float4 gv = *reinterpret_cast<const float4*>(&s_g[r][c]);
            acc[i] += gv.x * x0;
            acc[i] += gv.y * x1;
            acc[i] += gv.z * x2;
            acc[i] += gv.w * x3;
          }
        }
      }
      __syncthreads();  // s_g and s_x are refilled
    }

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r0 + i * rstep;  // row within the pass
      if (r < rows) {
        const uint32_t word = r < 32 ? bits0 : bits1;
        dv[(b * block_h + p0 + r) * block_w + l] = (word >> (r % 32)) & 1u ? acc[i] : 0.f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches K5 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a block_w other than 128 or 256).
int voltrix_spmm_dvalues_f32(const void* bitmask, const void* hind,
                             const void* wob, const void* feat, const void* g,
                             void* dv, int total_blocks, int words, int block_h,
                             int block_w, int num_nodes, int source_rows, int d,
                             void* stream) {
  if (block_w != 128 && block_w != 256) return static_cast<int>(cudaErrorInvalidValue);
  spmm_dvalues_kernel<<<total_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(wob), static_cast<const float*>(feat),
      static_cast<const float*>(g), static_cast<float*>(dv), words, block_h,
      block_w, num_nodes, source_rows, d);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

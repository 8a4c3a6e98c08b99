// Kernel K4: the weighted SpMM, out[num_nodes, d] = (A o V) @ feat, over a
// plan that carries a dense float32 value tile per block
// (voltrix_spmm_tpu_torch/format/plan.py, `values`), for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/weighted.py:_spmm_weighted_kernel together
// with the row gather it consumes there (a jnp.take with mode="clip"). As on
// the TPU, the whole value tile multiplies the gathered rows and the bitmask
// is not read: a value placed off the bitmask counts.
//
// Design. The TPU walks the blocks in order and revisits a window's output
// tile while the window is unchanged. Here the block list is cut into tasks
// of kTaskBlocks consecutive blocks; one thread block per (task, chunk of dc
// feature columns) walks its blocks in order, keeps the window's partial
// sums in registers and flushes them with atomicAdd into an output the
// wrapper zero-filled, whenever the window changes and at the end of the
// task. A window that lies inside one task is flushed once onto zeros, so
// its rows are exact and deterministic; only a window cut by a task
// boundary (the hub windows) adds a few partial sums in a run-dependent
// order. Rows of empty windows stay zero.
//
// A thread block has dc x rg threads (at most 256): dc = min(d, 64) columns,
// so no thread idles at d = 40, and rg row groups. Per plan block it stages
// the block_h x block_w value tile (float4 loads, rows padded by 4 floats so
// the float4 reads of distinct rows hit distinct banks) and the block_w
// gathered rows' dc columns in shared memory; the lanes' source rows were
// staged one block ahead, so the tile and the gather are independent loads,
// all in flight at once. Thread t then sums column t % dc of rows t / dc +
// i * rg, i < nr = block_h / rg, reading 4 values of a row at once. The
// register array is sized by NR, the power of two at or above nr.
//
// Bound. At the GAT widths (d = 8 and 40, block 64 x 128) the kernel must
// read the value plane, 32 KB per block (416 MB on the ogbn-arxiv proxy),
// against 2 * 64 * 128 * d flops: 4 flops per byte at d = 8, so it is bound
// by device memory. At d = 40 the 16 rows a thread sums from shared memory
// cost more than the plane's bytes. The task cut spreads the hub window
// (837 blocks) over ~210 thread blocks instead of one, so no SM walks more
// than 4 tiles.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTaskBlocks = 4;  // consecutive plan blocks per thread block

template <int NR>
__global__ void __launch_bounds__(kMaxThreads, NR <= 2 ? 5 : 1)
spmm_weighted_kernel(const float* __restrict__ values,       // (B, H, K)
                     const int32_t* __restrict__ hind,       // (B, K)
                     const int32_t* __restrict__ wob,        // (B,)
                     const float* __restrict__ feat,         // (source_rows, d)
                     float* __restrict__ out,                // (num_nodes, d), zeroed
                     int total_blocks, int block_h, int block_w, int num_nodes,
                     int source_rows, int d, int dc, int rg) {
  extern __shared__ float4 smem4[];
  const int vstride = block_w + 4;
  float* s_v = reinterpret_cast<float*>(smem4);           // (block_h, block_w + 4)
  float* s_x = s_v + block_h * vstride;                   // (block_w, dc)
  int* s_h = reinterpret_cast<int*>(s_x + block_w * dc);  // (2, block_w) source rows

  const int nthreads = dc * rg;
  const int t = threadIdx.x;
  const int c = t % dc;
  const int r0 = t / dc;
  const int nr = block_h / rg;
  const int c0 = blockIdx.y * dc;
  const bool col_ok = c0 + c < d;
  const int k4 = block_w / 4;  // a power of two (the wrapper checks)
  const int k4_shift = __ffs(k4) - 1;

  const int b_begin = blockIdx.x * kTaskBlocks;
  const int b_end = min(b_begin + kTaskBlocks, total_blocks);

  auto load_rows = [&](int b, int* dst) {
    for (int l = t; l < block_w; l += nthreads) {
      const int src = hind[(int64_t)b * block_w + l];
      dst[l] = min(max(src, 0), source_rows - 1);  // jnp.take(mode="clip")
    }
  };
  load_rows(b_begin, s_h);
  __syncthreads();

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;

  auto flush = [&](int w) {
    if (!col_ok) return;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int64_t row = (int64_t)w * block_h + r0 + i * rg;
      if (i < nr && row < num_nodes) atomicAdd(&out[row * d + c0 + c], acc[i]);
      acc[i] = 0.f;
    }
  };

  const int tile4 = block_h * k4;
  for (int b = b_begin, buf = 0; b < b_end; ++b, buf ^= 1) {
    const int* rows = s_h + buf * block_w;
    // The next block's source rows go to the other buffer, last read
    // before the previous iteration's barriers; every load below is
    // independent of the others, so they are all in flight at once.
    if (b + 1 < b_end) load_rows(b + 1, s_h + (buf ^ 1) * block_w);
    const float4* v4 = reinterpret_cast<const float4*>(values + (int64_t)b * block_h * block_w);
#pragma unroll 4
    for (int i = t; i < tile4; i += nthreads) {
      const int r = i >> k4_shift, l4 = i & (k4 - 1);
      *reinterpret_cast<float4*>(&s_v[r * vstride + 4 * l4]) = v4[i];
    }
#pragma unroll 4
    for (int l = r0; l < block_w; l += rg) {
      s_x[l * dc + c] = col_ok ? feat[(int64_t)rows[l] * d + c0 + c] : 0.f;
    }
    __syncthreads();
    for (int l = 0; l < block_w; l += 4) {
      const float x0 = s_x[(l + 0) * dc + c];
      const float x1 = s_x[(l + 1) * dc + c];
      const float x2 = s_x[(l + 2) * dc + c];
      const float x3 = s_x[(l + 3) * dc + c];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (i >= nr) break;
        const float4 v = *reinterpret_cast<const float4*>(&s_v[(r0 + i * rg) * vstride + l]);
        acc[i] += v.x * x0;
        acc[i] += v.y * x1;
        acc[i] += v.z * x2;
        acc[i] += v.w * x3;
      }
    }
    __syncthreads();  // s_v, s_x and this buffer of s_h are refilled
    const int w = wob[b];
    if (b + 1 == b_end || wob[b + 1] != w) flush(w);
  }
}

template <int NR>
int launch(const float* values, const int32_t* hind, const int32_t* wob,
           const float* feat, float* out, int total_blocks, int block_h,
           int block_w, int num_nodes, int source_rows, int d, int dc, int rg,
           cudaStream_t stream) {
  const int smem = (block_h * (block_w + 4) + block_w * dc + 2 * block_w) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      spmm_weighted_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((total_blocks + kTaskBlocks - 1) / kTaskBlocks, (d + dc - 1) / dc);
  spmm_weighted_kernel<NR><<<grid, dc * rg, smem, stream>>>(
      values, hind, wob, feat, out, total_blocks, block_h, block_w, num_nodes,
      source_rows, d, dc, rg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K4 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take). `out`
// must be zero-filled. The wrapper picks dc feature columns and rg row
// groups per thread block: dc * rg <= 256 threads, rg divides block_h, and
// each thread sums nr = block_h / rg <= 32 rows.
int voltrix_spmm_weighted_f32(const void* values, const void* hind,
                              const void* wob, const void* feat, void* out,
                              int total_blocks, int block_h, int block_w,
                              int num_nodes, int source_rows, int d, int dc,
                              int rg, void* stream) {
  const auto* v = static_cast<const float*>(values);
  const auto* h = static_cast<const int32_t*>(hind);
  const auto* wb = static_cast<const int32_t*>(wob);
  const auto* x = static_cast<const float*>(feat);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int k4 = block_w / 4;
  if (dc <= 0 || rg <= 0 || dc * rg > kMaxThreads || block_h % rg || block_w % 4 ||
      k4 <= 0 || (k4 & (k4 - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nr = block_h / rg;
  switch (nr <= 1 ? 1 : nr <= 2 ? 2 : nr <= 4 ? 4 : nr <= 8 ? 8 : nr <= 16 ? 16 : nr <= 32 ? 32 : 0) {
    case 1: return launch<1>(v, h, wb, x, o, total_blocks, block_h, block_w, num_nodes, source_rows, d, dc, rg, s);
    case 2: return launch<2>(v, h, wb, x, o, total_blocks, block_h, block_w, num_nodes, source_rows, d, dc, rg, s);
    case 4: return launch<4>(v, h, wb, x, o, total_blocks, block_h, block_w, num_nodes, source_rows, d, dc, rg, s);
    case 8: return launch<8>(v, h, wb, x, o, total_blocks, block_h, block_w, num_nodes, source_rows, d, dc, rg, s);
    case 16: return launch<16>(v, h, wb, x, o, total_blocks, block_h, block_w, num_nodes, source_rows, d, dc, rg, s);
    case 32: return launch<32>(v, h, wb, x, o, total_blocks, block_h, block_w, num_nodes, source_rows, d, dc, rg, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

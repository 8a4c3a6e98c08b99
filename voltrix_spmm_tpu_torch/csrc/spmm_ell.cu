// Kernel K6: the ELL SpMM, out[num_nodes, d] = (A o V) @ feat, over the
// edge-per-lane plan (voltrix_spmm_tpu_torch/format/ell.py), for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/ell.py:_ell_fwd_kernel together with the
// row gather it consumes there (a jnp.take with mode="clip"). The TPU
// rebuilds each block's (block_h, block_w) value tile with a compare
// against a row iota and multiplies it by the gathered rows on the MXU:
// block_h times the work the edges need. Here each lane is one edge and
// does only its own row: out[w * block_h + erow[l]] += vals[l] * feat[hind[l]].
// A padding lane (erow = -1) is skipped, whatever `vals` holds there, as
// the iota compare never matches -1 on the TPU.
//
// Design. The TPU revisits a window's output tile while the grid walks the
// window's blocks in order. Here the block list is cut into tasks of
// task_blocks consecutive blocks, one thread block per (task, chunk of dc
// feature columns), so the hub window (3,064 blocks on the ogbn-arxiv
// proxy at h128) spreads over hundreds of thread blocks instead of one.
// A thread block stages its task's lanes (source row, destination row,
// value) in shared memory, then walks the task's runs of blocks of one
// window. Lanes of a window are sorted by (column, row), so consecutive
// lanes hit scattered rows: each thread adds its products into a
// (block_h x dc) tile in shared memory with shared-memory atomics, and the
// tile's touched rows are flushed into the zero-filled output with one
// global atomicAdd per (row, column) when the window ends. The sum order
// changes from run to run (shared and global atomics).
//
// Threads: dc = min(d, 64) columns (so no thread idles at d = 40) by
// 256 / dc lane groups. Thread (g, c) takes lanes g, g + groups, ... of
// the run, four at a time so that four gathers are in flight. The tile's
// rows are padded to an odd stride, so the lane groups of one warp, which
// hit different rows, rarely share a bank.
//
// Bound. Per lane the kernel reads 12 bytes of plan and gathers one dc-wide
// row of feat; the bound counts feat once (it stays in the 50 MB L2 on the
// ogbn-arxiv and ogbl-ddi proxies), so the gathers, not the flops (2 per
// lane and column), are what separates the kernel from its bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // lanes a thread gathers before it adds

__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const int32_t* __restrict__ hind,  // (B, K)
                const int32_t* __restrict__ erow,  // (B, K), -1 padding
                const float* __restrict__ vals,    // (B, K)
                const int32_t* __restrict__ wob,   // (B,)
                const float* __restrict__ feat,    // (source_rows, d)
                float* __restrict__ out,           // (num_nodes, d), zeroed
                int total_blocks, int block_h, int block_w, int num_nodes,
                int source_rows, int d, int dc, int task_blocks) {
  extern __shared__ float smem[];
  const int stride = dc | 1;
  const int task_lanes = task_blocks * block_w;
  float* s_acc = smem;                                                // (block_h, stride)
  int* s_mark = reinterpret_cast<int*>(s_acc + block_h * stride);     // (block_h,)
  int* s_src = s_mark + block_h;                                      // (task_lanes,)
  int* s_row = s_src + task_lanes;                                    // (task_lanes,)
  float* s_val = reinterpret_cast<float*>(s_row + task_lanes);        // (task_lanes,)
  int* s_wob = reinterpret_cast<int*>(s_val + task_lanes);            // (task_blocks,)

  const int nthreads = blockDim.x;
  const int groups = nthreads / dc;
  const int t = threadIdx.x;
  const int c = t % dc;
  const int g = t / dc;
  const int c0 = blockIdx.y * dc;
  const bool col_ok = c0 + c < d;

  const int b_begin = blockIdx.x * task_blocks;
  const int nb = min(task_blocks, total_blocks - b_begin);
  const int64_t base = (int64_t)b_begin * block_w;
  for (int i = t; i < nb * block_w; i += nthreads) {
    const int src = hind[base + i];
    s_src[i] = min(max(src, 0), source_rows - 1);  // jnp.take(mode="clip")
    s_row[i] = erow[base + i];
    s_val[i] = vals[base + i];
  }
  for (int i = t; i < nb; i += nthreads) s_wob[i] = wob[b_begin + i];
  for (int i = t; i < block_h * stride; i += nthreads) s_acc[i] = 0.f;
  // s_mark[r] == run + 1 marks row r as touched by the current run, so
  // the marks never need clearing
  for (int i = t; i < block_h; i += nthreads) s_mark[i] = 0;
  __syncthreads();

  int run = 0;
  for (int b = 0; b < nb; ++run) {
    const int w = s_wob[b];
    int e = b + 1;
    while (e < nb && s_wob[e] == w) ++e;
    const int lo = b * block_w;
    const int hi = e * block_w;
    if (col_ok) {
      for (int l0 = lo + g; l0 < hi; l0 += kUnroll * groups) {
        int r[kUnroll];
        float p[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int l = l0 + u * groups;
          r[u] = l < hi ? s_row[l] : -1;
          p[u] = 0.f;
          if ((unsigned)r[u] < (unsigned)block_h) {
            p[u] = s_val[l] * __ldg(&feat[(int64_t)s_src[l] * d + c0 + c]);
          } else {
            r[u] = -1;  // a padding lane: skipped, whatever its value
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r[u] >= 0) {
            atomicAdd(&s_acc[r[u] * stride + c], p[u]);
            if (c == 0) s_mark[r[u]] = run + 1;
          }
        }
      }
    }
    __syncthreads();  // the run's sums and marks are complete
    for (int rr = g; rr < block_h; rr += groups) {
      if (s_mark[rr] == run + 1) {
        const int64_t row = (int64_t)w * block_h + rr;
        if (col_ok && row < num_nodes) atomicAdd(&out[row * d + c0 + c], s_acc[rr * stride + c]);
        s_acc[rr * stride + c] = 0.f;
      }
    }
    __syncthreads();  // the tile is zero again before the next run adds
    b = e;
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take). `out`
// must be zero-filled. The wrapper picks dc columns per thread block (the
// block has dc * (256 / dc) threads) and task_blocks plan blocks per task;
// the launch needs (block_h * (dc | 1) + block_h + 3 * task_blocks *
// block_w + task_blocks) * 4 bytes of shared memory.
int voltrix_spmm_ell_f32(const void* hind, const void* erow, const void* vals,
                         const void* wob, const void* feat, void* out,
                         int total_blocks, int block_h, int block_w, int num_nodes,
                         int source_rows, int d, int dc, int task_blocks, void* stream) {
  if (dc <= 0 || dc > kThreads || task_blocks <= 0 || block_h <= 0 || block_w <= 0 ||
      total_blocks <= 0 || d <= 0 || source_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = ((int64_t)block_h * (dc | 1) + block_h +
                        3 * (int64_t)task_blocks * block_w + task_blocks) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_ell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((total_blocks + task_blocks - 1) / task_blocks, (d + dc - 1) / dc);
  const int threads = dc * (kThreads / dc);
  spmm_ell_kernel<<<grid, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hind), static_cast<const int32_t*>(erow),
      static_cast<const float*>(vals), static_cast<const int32_t*>(wob),
      static_cast<const float*>(feat), static_cast<float*>(out), total_blocks, block_h,
      block_w, num_nodes, source_rows, d, dc, task_blocks);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Kernel K7: the ELL lane gradient and SDDMM, for sm_90a:
//   out[b, l] = g[wob[b] * block_h + erow[b, l]] . feat[hind[b, l]]
// over the edge-per-lane plan (voltrix_spmm_tpu_torch/format/ell.py), and
// exactly 0.0 on padding lanes (erow = -1). With g = d/d(out) of K6 it is
// the gradient of K6's lane values; with g = x and feat = y it is the
// SDDMM score x[u] . y[v] of every edge (u, v).
//
// Replaces voltrix_spmm_tpu/ops/ell.py:_ell_dvals_kernel together with the
// row gather it consumes there. The TPU computes the whole (block_h,
// block_w) product g_window @ xg^T on the MXU and folds each lane's column
// with a row select: block_h times the work. Here each lane computes only
// its own dot product of length d. Two kernels, chosen by a fixed width
// rule (ops/ell.py:_k7_wide):
//
// Narrow rows (spmm_ell_dvals_kernel; path E's d 8 and 40). A sub-group of
// `sub` threads (a power of two up to 32) takes one lane: it reads the
// lane's destination row of g and source row of feat, `vec` floats at a
// time (float4 when d % 4 == 0 and both tensors are 16-byte aligned), and
// sums with warp shuffles inside the sub-group. The wrapper picks sub as
// the power of two at or above half the row's vectors: at d = 8 one thread
// takes a lane (two float4 per row, no shuffle), at d = 40 eight threads
// take a lane. A padding lane's sub-group reads nothing and writes 0.0; it
// still joins the shuffles, which every thread of a warp must reach.
//
// Wide rows (spmm_ell_dvals_wide_kernel; path F's d 256). The lanes of
// each window, grouped by source row in lane order (ops/ell.py:
// ell_source_order, built once per plan), are cut into pieces of at most
// DVALS_PIECE_LANES lanes; one thread block of 16 warps per piece. It
// stages the window's block_h rows of g in shared memory with bulk copies
// (one contiguous range of g), and splits the piece's lanes into 16
// consecutive runs, one a warp. A warp keeps the feat row of its current
// source in registers (lane l: columns 4l .. 4l + 3 of each 128), reloads
// it only when the source changes (about 35 lanes a source on path F), and
// for each lane reads the g row from shared memory (16 bytes a lane,
// conflict-free) and multiplies; four lanes' partial dot products are summed
// across the warp together in 6 shuffles, in a fixed order. The wrapper
// zeroes the output first, so padding lanes read 0.0; every other lane is
// written once. Each g row is read from L2 once per piece, each feat row
// once per run of its lanes, instead of both once per lane.
//
// Bound. Per lane the kernel reads 8 bytes of plan and two rows of d
// floats; the bound counts g and feat once, so on path F (5.1M lanes at
// d 256) the operations set it: 2.6 GFLOP, 0.039 ms at 67 TFLOP/s.

#include <cstdint>

#include <cuda_runtime.h>

#include "spmm_walk.cuh"

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float dot(float a, float b) { return a * b; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_ell_dvals_kernel(const int32_t* __restrict__ hind,  // (B, K)
                      const int32_t* __restrict__ erow,  // (B, K), -1 padding
                      const int32_t* __restrict__ wob,   // (B,)
                      const float* __restrict__ feat,    // (source_rows, d)
                      const float* __restrict__ g,       // (num_nodes, d)
                      float* __restrict__ out,           // (B, K)
                      int64_t total_lanes, int block_h, int block_w, int num_nodes,
                      int source_rows, int d, int sub) {
  using T = typename Vec<VEC>::T;
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t lane = gt / sub;
  const int j = threadIdx.x & (sub - 1);
  const int units = d / VEC;
  float acc = 0.f;
  if (lane < total_lanes) {
    const int r = erow[lane];
    if ((unsigned)r < (unsigned)block_h) {
      const int64_t row = (int64_t)wob[lane / block_w] * block_h + r;
      if (row < num_nodes) {
        const int src = min(max(hind[lane], 0), source_rows - 1);  // jnp.take(mode="clip")
        const T* x = reinterpret_cast<const T*>(feat + (int64_t)src * d);
        const T* gr = reinterpret_cast<const T*>(g + row * d);
        for (int u = j; u < units; u += sub) acc += Vec<VEC>::dot(__ldg(&gr[u]), __ldg(&x[u]));
      }
    }
  }
  for (int off = sub >> 1; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, sub);
  if (lane < total_lanes && j == 0) out[lane] = acc;  // 0.0 on padding lanes
}

constexpr int kWideWarps = 16;

using voltrix_walk::bulk_copy;
using voltrix_walk::mbar_arrive_expect_tx;
using voltrix_walk::mbar_init;
using voltrix_walk::mbar_wait;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NV: float4 columns a lane holds (d <= 128 NV); d % 4 == 0, g and feat
// 16-byte aligned
template <int NV>
__global__ void __launch_bounds__(32 * kWideWarps, 1)
spmm_ell_dvals_wide_kernel(const int32_t* __restrict__ pieces,  // (P, 3): window, first, end
                           const int32_t* __restrict__ lane_of,  // (E,) flat lane, by source
                           const int32_t* __restrict__ src_of,   // (E,) source row, clipped
                           const int32_t* __restrict__ row_of,   // (E,) row in the window
                           const float* __restrict__ feat,       // (source_rows, d)
                           const float* __restrict__ g,          // (num_nodes, d)
                           float* __restrict__ out,              // (B * K,), zeroed
                           int block_h, int num_nodes, int d) {
  extern __shared__ __align__(16) float s_g[];  // (rows, d): the window's g rows
  __shared__ __align__(8) uint64_t bar;
  const int* pc = pieces + (int64_t)blockIdx.x * 3;
  const int w = pc[0], first = pc[1], end = pc[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)w * block_h;
  const int64_t left = (int64_t)num_nodes - row0;
  const int rows = left < block_h ? (int)left : block_h;

  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the window's g rows, one contiguous range
    const uint32_t total = static_cast<uint32_t>(rows) * d * 4;
    mbar_arrive_expect_tx(&bar, total);
    constexpr uint32_t kPart = 32768;
    const char* src = reinterpret_cast<const char*>(g + row0 * d);
    char* dst = reinterpret_cast<char*>(s_g);
    for (uint32_t off = 0; off < total; off += kPart) {
      bulk_copy(dst + off, src + off, total - off < kPart ? total - off : kPart, &bar);
    }
  }

  // this warp's run of the piece's lanes
  const int n = end - first;
  const int per = (n + kWideWarps - 1) / kWideWarps;
  const int e0 = first + warp * per;
  const int e1 = min(end, e0 + per);
  int cur = -1;
  float4 fv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) fv[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  bool waited = false;
  for (int base = e0; base < e1; base += 32) {
    const int cnt = min(32, e1 - base);
    int my_lane = 0, my_src = 0, my_row = 0;
    if (lane < cnt) {
      my_lane = __ldg(lane_of + base + lane);
      my_src = __ldg(src_of + base + lane);
      my_row = __ldg(row_of + base + lane);
    }
    if (!waited) {
      mbar_wait(&bar, 0);
      waited = true;
    }
    for (int j0 = 0; j0 < cnt; j0 += 4) {
      float p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        p[q] = 0.f;
        const int j = j0 + q;
        if (j < cnt) {  // uniform across the warp
          const int s = __shfl_sync(0xffffffffu, my_src, j);
          const int r = __shfl_sync(0xffffffffu, my_row, j);
          if (s != cur) {
            cur = s;
            const float* fr = feat + (int64_t)s * d;
#pragma unroll
            for (int k = 0; k < NV; ++k) {
              const int c = 128 * k + 4 * lane;
              if (c < d) fv[k] = __ldg(reinterpret_cast<const float4*>(fr + c));
            }
          }
          const float* gr = s_g + r * d;
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int c = 128 * k + 4 * lane;
            if (c < d) p[q] = dot4(*reinterpret_cast<const float4*>(gr + c), fv[k], p[q]);
          }
        }
      }
      // the four partial sums across the warp: lanes 8e .. 8e + 7 end with
      // lane j0 + e's total
      const bool hi = lane & 16;
      float k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
      k0 += __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 16);
      k1 += __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 16);
      const bool mid = lane & 8;
      float v = mid ? k1 : k0;
      v += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      const int e = (lane >> 3) & 3;
      const int dst = __shfl_sync(0xffffffffu, my_lane, j0 + e);
      if ((lane & 7) == 0 && j0 + e < cnt) out[dst] = v;
    }
  }
  // a warp without lanes waits too, so no copy outlives the block
  if (!waited) mbar_wait(&bar, 0);
}

}  // namespace

extern "C" {

// Launches K7 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for arguments it does not take). vec is 1
// or 4 (4 needs d % 4 == 0 and 16-byte aligned feat and g); sub is a power
// of two up to 32 threads per lane. Every lane of `out` is written.
int voltrix_spmm_ell_dvals_f32(const void* hind, const void* erow, const void* wob,
                               const void* feat, const void* g, void* out,
                               int64_t total_lanes, int block_h, int block_w,
                               int num_nodes, int source_rows, int d, int vec, int sub,
                               void* stream) {
  if (total_lanes <= 0 || block_h <= 0 || block_w <= 0 || d <= 0 || source_rows <= 0 ||
      sub <= 0 || sub > 32 || (sub & (sub - 1)) || (vec != 1 && vec != 4) || d % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (total_lanes * sub + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int32_t*>(hind);
  const auto* e = static_cast<const int32_t*>(erow);
  const auto* wb = static_cast<const int32_t*>(wob);
  const auto* x = static_cast<const float*>(feat);
  const auto* gg = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  if (vec == 4) {
    spmm_ell_dvals_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        h, e, wb, x, gg, o, total_lanes, block_h, block_w, num_nodes, source_rows, d, sub);
  } else {
    spmm_ell_dvals_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        h, e, wb, x, gg, o, total_lanes, block_h, block_w, num_nodes, source_rows, d, sub);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K7's wide kernel on `stream` over `num_pieces` pieces (int32
// (num_pieces, 3): window, first, end into the source-ordered lane_of,
// src_of and row_of) and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for arguments it does not take). `out` must hold
// zeros; d % 4 == 0, d <= 512, g and feat 16-byte aligned, and block_h rows
// of g fit in shared memory.
int voltrix_spmm_ell_dvals_wide_f32(const void* pieces, const void* lane_of, const void* src_of,
                                    const void* row_of, const void* feat, const void* g,
                                    void* out, int num_pieces, int block_h, int num_nodes, int d,
                                    void* stream) {
  if (num_pieces <= 0 || block_h <= 0 || d <= 0 || d % 4 || d > 512) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = block_h * d * 4;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pc = static_cast<const int32_t*>(pieces);
  const auto* la = static_cast<const int32_t*>(lane_of);
  const auto* sr = static_cast<const int32_t*>(src_of);
  const auto* ro = static_cast<const int32_t*>(row_of);
  const auto* x = static_cast<const float*>(feat);
  const auto* gg = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  const int nv = (d + 127) / 128;
  auto kernel = nv == 1   ? spmm_ell_dvals_wide_kernel<1>
                : nv == 2 ? spmm_ell_dvals_wide_kernel<2>
                : nv == 3 ? spmm_ell_dvals_wide_kernel<3>
                          : spmm_ell_dvals_wide_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<num_pieces, 32 * kWideWarps, smem, s>>>(pc, la, sr, ro, x, gg, o, block_h, num_nodes,
                                                   d);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

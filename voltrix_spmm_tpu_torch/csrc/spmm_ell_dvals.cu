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
// its own dot product of length d.
//
// Design. A sub-group of `sub` threads (a power of two up to 32) takes one
// lane: it reads the lane's destination row of g and source row of feat,
// `vec` floats at a time (float4 when d % 4 == 0 and both tensors are
// 16-byte aligned), and sums with warp shuffles inside the sub-group. The
// wrapper picks sub as the power of two at or above half the row's
// vectors: at d = 8 one thread takes a lane (two float4 per row, no
// shuffle), at d = 40 eight threads take a lane, at d = 256 a warp does. A
// padding lane's sub-group reads nothing and writes 0.0; it still joins
// the shuffles, which every thread of a warp must reach.
//
// Bound. Per lane the kernel reads 8 bytes of plan and gathers two rows of
// d floats; the bound counts g and feat once (each is read many times
// through L1 and L2, one window's g rows by all its lanes), so the
// gathers set the distance to the bound.

#include <cstdint>

#include <cuda_runtime.h>

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

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

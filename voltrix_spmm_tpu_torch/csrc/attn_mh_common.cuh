// Pieces shared by the fused graph attention kernels, K9 and K13
// (attn_fwd.cu), K10 (attn_bwd.cu), K14 (attn_mh_dq.cu) and K15
// (attn_mh_dkv.cu; at one head K11 and K12), all on the row walk of
// attn_walk.cuh: typed row loads, the activation and its derivative, and
// the rows of a window.

#pragma once

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace voltrix_attn {

constexpr float kNeg = -1e30f;      // finite -inf stand-in (ops/attention_mh.py:_NEG)
constexpr float kEmptyLse = 1e30f;  // lse of a row with no edges

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive values as floats; p is 16-byte (float) or 8-byte
// (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// leaky_relu(scale * raw) with `slope` (1.0: the identity), as
// attention.py:_score_tile applies it.
__device__ __forceinline__ float act(float raw, float scale, float slope) {
  const float s = raw * scale;
  return s > 0.f ? s : s * slope;
}

// The JAX backward's activation derivative: ds *= (raw > 0 ? 1 : slope).
__device__ __forceinline__ float act_grad(float raw, float slope) {
  return raw > 0.f ? 1.f : slope;
}

// Rows of the window starting at row0 that exist (n rows in all).
__device__ __forceinline__ int window_rows(int64_t row0, int block_h, int64_t n) {
  const int64_t rem = n - row0;
  return rem <= 0 ? 0 : (rem < block_h ? static_cast<int>(rem) : block_h);
}

}  // namespace voltrix_attn

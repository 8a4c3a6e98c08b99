// The merge of kernels K9 and K13 (csrc/attn_fwd.cu) and of their
// compute_dtype=bfloat16 kernels (csrc/attn_fwd_bf16.cu): a cut group's
// rows from its pieces' (m, l, acc) shares, in a fixed order.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "attn_walk.cuh"

namespace voltrix_fwd_merge {

using voltrix_attn::kEmptyLse;
using voltrix_attn::kNeg;
using voltrix_attn_walk::group_rows;
using voltrix_attn_walk::kThreads;
using voltrix_attn_walk::kWarps;
using voltrix_walk::kMCount;
using voltrix_walk::kMergeInts;
using voltrix_walk::kMG;
using voltrix_walk::kMSlot;
using voltrix_walk::kMW;
using voltrix_walk::tile_rows;

constexpr int kMergeCols = 128;  // columns of a merge thread block: four a lane
constexpr int kMergeBatch = 8;   // shares a merge lane loads at once

// The rows of each cut group, from its pieces' shares. One thread block
// per (cut group, kWarps of its rows, chunk of kMergeCols columns), a warp
// per row: the row's largest share maximum M once for the row (a warp
// max), then cl lanes cover the chunk's columns four at a time and the
// warp's 32 / cl groups of them take every (32 / cl)-th share, each
// rescaled by exp(m_share - M), kMergeBatch loads at once; the groups'
// sums of l and of the columns then add up by a fixed shuffle tree. The
// order is fixed, so the rows are the same in every run, and a hub
// window's hundreds of shares spread over the warp at small widths.
__global__ void __launch_bounds__(kThreads)
attn_fwd_merge_kernel(const int32_t* __restrict__ merges,  // (cut groups, kMergeInts)
                      const float* __restrict__ ws_ml, const float* __restrict__ ws_acc,
                      float* __restrict__ out, float* __restrict__ lse, int heads, int words,
                      int block_h, int nq, int dv, int64_t padded, int cl) {
  const int tile = tile_rows(words);
  const int strips = tile / kWarps;
  const int* mg = merges + (int64_t)(blockIdx.x / strips) * kMergeInts;
  const int w = mg[kMW], g = mg[kMG], first = mg[kMSlot], count = mg[kMCount];
  const int r = (blockIdx.x % strips) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= group_rows(g, words, block_h)) return;
  const int h = blockIdx.z;  // the head: its shares lie `tile` rows apart in each slot
  out += (int64_t)h * nq * dv;
  lse += h * padded;
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * g + r;
  const float* ml = ws_ml + (((int64_t)first * heads + h) * tile + r) * 2;
  const int64_t ml_stride = (int64_t)heads * tile * 2;
  float big = kNeg;  // the row's largest share maximum, once for the row
  for (int p = lane; p < count; p += 32) big = fmaxf(big, ml[p * ml_stride]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));

  const int c0 = blockIdx.y * kMergeCols;
  const int cw = min(kMergeCols, dv - c0);
  const int groups = 32 / cl, grp = lane / cl, c = 4 * (lane % cl);
  const bool vec = dv % 4 == 0, mine = c < cw;
  const float* a0 = ws_acc + (((int64_t)first * heads + h) * tile + r) * dv + c0 + c;
  const int64_t a_stride = (int64_t)heads * tile * dv;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int p0 = grp; p0 < count; p0 += kMergeBatch * groups) {
    float f[kMergeBatch];
    float4 x[kMergeBatch];
#pragma unroll
    for (int t = 0; t < kMergeBatch; ++t) {
      const int p = p0 + t * groups;
      f[t] = 0.f;
      x[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < count) {
        const float* sh = ml + p * ml_stride;
        f[t] = expf(sh[0] - big);
        den = fmaf(sh[1], f[t], den);
        const float* src = a0 + p * a_stride;
        if (mine && vec) {
          x[t] = __ldg(reinterpret_cast<const float4*>(src));
        } else if (mine) {
          x[t].x = __ldg(src);
          if (c + 1 < cw) x[t].y = __ldg(src + 1);
          if (c + 2 < cw) x[t].z = __ldg(src + 2);
          if (c + 3 < cw) x[t].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMergeBatch; ++t) {
      a.x = fmaf(f[t], x[t].x, a.x);
      a.y = fmaf(f[t], x[t].y, a.y);
      a.z = fmaf(f[t], x[t].z, a.z);
      a.w = fmaf(f[t], x[t].w, a.w);
    }
  }
  for (int o = cl; o < 32; o <<= 1) {  // the groups' sums, a fixed tree
    den += __shfl_xor_sync(0xffffffffu, den, o);
    a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
  }
  if (grp == 0 && mine && row < nq) {
    const float inv = 1.f / fmaxf(den, 1e-30f);
    float* o = out + row * dv + c0 + c;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    } else {
      o[0] = a.x * inv;
      if (c + 1 < cw) o[1] = a.y * inv;
      if (c + 2 < cw) o[2] = a.z * inv;
      if (c + 3 < cw) o[3] = a.w * inv;
    }
  }
  if (blockIdx.y == 0 && lane == 0) {
    lse[row] = den > 0.f ? big + logf(fmaxf(den, 1e-30f)) : kEmptyLse;
  }
}

// The merge of the cut groups' shares, for `heads` heads (blockIdx.z).
inline int launch_merge(const void* merges, const void* ws_ml, const void* ws_acc, void* out,
                        void* lse, int num_merges, int heads, int words, int block_h, int nq,
                        int dv, int64_t padded, cudaStream_t s) {
  const int strips = tile_rows(words) / kWarps;
  int cl = 1;  // lanes a chunk's columns take, four columns a lane
  while (cl < 32 && 4 * cl < min(dv, kMergeCols)) cl *= 2;
  attn_fwd_merge_kernel<<<dim3(num_merges * strips, (dv + kMergeCols - 1) / kMergeCols, heads),
                          kThreads, 0, s>>>(
      static_cast<const int32_t*>(merges), static_cast<const float*>(ws_ml),
      static_cast<const float*>(ws_acc), static_cast<float*>(out), static_cast<float*>(lse),
      heads, words, block_h, nq, dv, padded, cl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace voltrix_fwd_merge

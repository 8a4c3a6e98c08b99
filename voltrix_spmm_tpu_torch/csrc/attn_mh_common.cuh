// Pieces shared by kernels K14 and K15, the backward of the multi-head
// fused graph attention (attn_mh_dq.cu, attn_mh_dkv.cu; at one head K11
// and K12), and by the row walk of K9, K10 and K13 (attn_walk.cuh): typed
// row loads, the activation, the row-sorted walk over a run's set bits and
// the flush of an additive row tile.
//
// Work split of K14 and K15. The TPU walks each window's block list in
// order with a (block_h, K) score tile per step. Here the plan's block
// list is cut into tasks of task_blocks consecutive blocks, one thread
// block per (task, group of up to 8 heads, column chunk), as K6 did, so the
// hub window (904 blocks on the ogbn-arxiv proxy at h128u4) spreads over
// ~113 thread blocks instead of one. A task walks its runs (the blocks of
// one window) and, within a run, deals the set bits out to its threads
// (for_each_edge): only the edges are visited, about 1% of the (block_h x
// K) slots on the arxiv proxy, where a dense score tile would spend ~99% of
// its exps on masked slots. The edges' sums go into a (heads x block_h x
// dc) row tile in shared memory (for_each_edge_batch), which goes to the
// output when the run ends.

#pragma once

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace voltrix_attn {

constexpr int kThreads = 256;
// dynamic shared memory a thread block may use on sm_90, less the walks'
// static scratch (kScanInts ints and a flag)
constexpr int kSmemLimit = 232448 - 4 * (2 * kThreads + 33) - 16;
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

// acc[0..4) += coef * row[0..4)
template <typename T>
__device__ __forceinline__ void axpy4(float coef, const T* row, float4& acc) {
  const float4 x = load4(row);
  acc.x = fmaf(coef, x.x, acc.x);
  acc.y = fmaf(coef, x.y, acc.y);
  acc.z = fmaf(coef, x.z, acc.z);
  acc.w = fmaf(coef, x.w, acc.w);
}

// The dot of two rows of width d, four values at a time when vec4.
template <typename A, typename B>
__device__ __forceinline__ float dot(const A* __restrict__ a, const B* __restrict__ b, int d,
                                     int vec4) {
  float s = 0.f;
  if (vec4) {
    for (int c = 0; c < d; c += 4) {
      const float4 x = load4(a + c);
      const float4 y = load4(b + c);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
  } else {
    for (int c = 0; c < d; ++c) s = fmaf(to_f(a[c]), to_f(b[c]), s);
  }
  return s;
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

// Shared ints the edge walks need (per thread block of kThreads threads).
constexpr int kScanInts = 2 * kThreads + 33;
// Edges a thread holds in one row-sorted batch, and the batch's size.
constexpr int kPerThread = 2;
constexpr int kBatch = kPerThread * kThreads;
// Heads a thread block serves at most: the bit walk and the row sort are
// done once for the group.
constexpr int kMaxHeadGroup = 8;

// Balance. Lanes hold 1.3 bits on average on the arxiv proxy, but the hub
// window's lanes hold up to 128 (the hubs' own columns). A thread walking
// its own lane's bits would keep its warp busy for as long as the warp's
// busiest lane, with one thread of 32 active. So the edges, not the lanes,
// are dealt out: for each chunk of blockDim.x lanes the block counts each
// lane's bits (one lane a thread, coalesced loads of hind and the bitmask)
// and scans the counts in shared memory (scan_chunk); thread t then takes
// edges t, t + blockDim.x, ... of the chunk, finding the edge's lane by
// binary search over the scan and its bit by rank within the lane's words
// (locate_edge). for_each_edge_batch below deals the edges out so.

// Scans the bit counts of lanes [base, base + blockDim.x) of the run that
// starts at block b0 (`lanes` lanes in all) into s_pre (blockDim.x + 1
// ints) and their clipped hind into s_src; returns the chunk's edge count.
// Ends with a barrier.
__device__ __forceinline__ int scan_chunk(const uint32_t* __restrict__ bitmask,
                                          const int32_t* __restrict__ hind, int b0, int base,
                                          int lanes, int words, int block_w, int src_rows,
                                          int* s_scan) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5;
  int* s_pre = s_scan;
  int* s_src = s_pre + nt + 1;
  int* s_warp = s_src + nt;
  int cnt = 0;
  if (base + t < lanes) {
    const int li = base + t;
    const uint32_t* wp =
        bitmask + ((int64_t)(b0 + li / block_w) * words) * block_w + li % block_w;
    for (int wd = 0; wd < words; ++wd) cnt += __popc(__ldg(&wp[(int64_t)wd * block_w]));
    s_src[t] = min(max(__ldg(&hind[(int64_t)b0 * block_w + li]), 0), src_rows - 1);
  }
  int x = cnt;  // inclusive scan within the warp, then across the warps
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int wsum = lane < (nt >> 5) ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wsum, o);
      if (lane >= o) wsum += y;
    }
    s_warp[lane] = wsum;
  }
  __syncthreads();
  s_pre[t + 1] = x + (warp > 0 ? s_warp[warp - 1] : 0);
  if (t == 0) s_pre[0] = 0;
  __syncthreads();
  return s_pre[nt];
}

// Edge k of the chunk scanned by scan_chunk: its row in the window (32 *
// word + bit); *src gets its lane's clipped hind.
__device__ __forceinline__ int locate_edge(const uint32_t* __restrict__ bitmask, int b0, int base,
                                           int k, int words, int block_w, const int* s_scan,
                                           int* src) {
  const int nt = blockDim.x;
  const int* s_pre = s_scan;
  int lo = 0, hi = nt;  // s_pre[lo] <= k < s_pre[hi]: lo is the edge's lane
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_pre[mid] <= k) lo = mid; else hi = mid;
  }
  *src = s_scan[nt + 1 + lo];
  const int li = base + lo;
  const uint32_t* wp = bitmask + ((int64_t)(b0 + li / block_w) * words) * block_w + li % block_w;
  int rank = k - s_pre[lo];
  int wd = 0;
  uint32_t word = __ldg(&wp[0]);
  for (int c = __popc(word); rank >= c; c = __popc(word)) {
    rank -= c;
    word = __ldg(&wp[(int64_t)(++wd) * block_w]);
  }
  for (; rank > 0; --rank) word &= word - 1;  // drop the lower set bits
  return wd * 32 + __ffs(static_cast<int>(word)) - 1;
}

// s_off[0..n] = the exclusive scan of s_cnt[0..n); every thread takes part.
// Ends with a barrier.
__device__ __forceinline__ void scan_rows(const int* s_cnt, int* s_off, int n, int* s_warp) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5;
  const int seg = (n + nt - 1) / nt;
  const int lo = min(n, t * seg), hi = min(n, lo + seg);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s_cnt[i];
  int x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int wsum = lane < (nt >> 5) ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wsum, o);
      if (lane >= o) wsum += y;
    }
    s_warp[lane] = wsum;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    s_off[i] = run;
    run += s_cnt[i];
  }
  if (t == nt - 1) s_off[n] = run;
  __syncthreads();
}

// The walk for sums. Shared float atomics are compare-and-swap loops on
// sm_90 (ATOMS.CAST.SPIN in the SASS), and a kernel adding dc columns per
// edge with them ran at about one add per 3 cycles per SM. So the edges
// of the run go in batches of up to kBatch, sorted by row: each edge
// counts itself into its row with a native integer atomic, the counts are
// scanned (s_off), and edge(r, src, slot, x) is called once per edge with
// the edge's slot in row order (s_esrc[slot] = src is set for it) and its
// place x in the batch, where the kernel stores the edge's coefficients.
// Then reduce(base, k0, kn) runs on every thread for the batch of edges
// k0 .. k0 + kn of the chunk of lanes from `base` (edge k0 + x of the
// chunk is lane l's when s_scan[l] <= k0 + x < s_scan[l + 1]): the kernel
// sums each row's slots s_off[r] .. s_off[r] + s_cnt[r] with a thread per
// (row, column), plain adds into rows it owns. An edge whose row lies
// past `rows` is dropped: edge() is not called for it. s_cnt (rows ints,
// zero on entry) is zero again on return. Ends with a barrier.
template <typename Edge, typename Reduce>
__device__ __forceinline__ void for_each_edge_batch(const uint32_t* __restrict__ bitmask,
                                                    const int32_t* __restrict__ hind, int b0,
                                                    int b1, int words, int block_w, int rows,
                                                    int src_rows, int* s_scan, int* s_cnt,
                                                    int* s_off, int* s_esrc, Edge&& edge,
                                                    Reduce&& reduce) {
  const int t = threadIdx.x, nt = blockDim.x;
  int* s_warp = s_scan + 2 * nt + 1;
  const int lanes = (b1 - b0) * block_w;
  for (int base = 0; base < lanes; base += nt) {
    const int total = scan_chunk(bitmask, hind, b0, base, lanes, words, block_w, src_rows, s_scan);
    for (int k0 = 0; k0 < total; k0 += kPerThread * nt) {
      const int kn = min(kPerThread * nt, total - k0);
      int er[kPerThread], es[kPerThread], ep[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int k = k0 + t + j * nt;
        er[j] = -1;
        es[j] = ep[j] = 0;
        if (k < total) {
          const int r = locate_edge(bitmask, b0, base, k, words, block_w, s_scan, &es[j]);
          if (r < rows) {
            er[j] = r;
            ep[j] = atomicAdd(&s_cnt[r], 1);
          }
        }
      }
      __syncthreads();
      scan_rows(s_cnt, s_off, rows, s_warp);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (er[j] >= 0) {
          const int slot = s_off[er[j]] + ep[j];
          s_esrc[slot] = es[j];
          edge(er[j], es[j], slot, t + j * nt);
        }
      }
      __syncthreads();
      reduce(base, k0, kn);
      __syncthreads();
      for (int i = t; i < rows; i += nt) s_cnt[i] = 0;
      __syncthreads();
    }
    __syncthreads();  // the next chunk overwrites the scan
  }
}

// Moves a run's tile (for each of `heads` heads, rows x cw at row stride
// `stride`, head j's rows at j * block_h) to the output at dst(j, r, c): a
// store when the task held the whole window, else an atomicAdd, since the
// window's other tasks add their shares to the same rows (the output
// starts zeroed). Each thread zeroes what it moved.
template <typename Dst>
__device__ __forceinline__ void flush_add(float* s_acc, int stride, int block_h, int heads,
                                          int rows, int cw, bool whole, Dst&& dst) {
  for (int i = threadIdx.x; i < heads * rows * cw; i += blockDim.x) {
    const int j = i / (rows * cw);
    const int r = (i / cw) % rows;
    const int c = i % cw;
    float* tile = s_acc + ((int64_t)j * block_h + r) * stride + c;
    const float val = *tile;
    if (whole) {
      *dst(j, r, c) = val;
    } else if (val != 0.f) {
      atomicAdd(dst(j, r, c), val);
    }
    *tile = 0.f;
  }
}

// Launches kernel with `smem` bytes of dynamic shared memory on `stream`,
// raising the limit first (the kernels' static shared memory counts
// against the default 48 KB too).
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int64_t smem, void* stream, Args... args) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace voltrix_attn

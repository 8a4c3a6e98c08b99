// The row walk that kernels K9 and K13 (csrc/attn_fwd.cu) and the dq pass
// of kernel K10 (csrc/attn_bwd.cu) share: fused graph attention over the
// binned block-CSR plan, for sm_90a. K13 walks once for a group of heads,
// its ring slots holding each head's rows in the plane's type
// (walk_items with a stage of its own).
//
// Work list. The wrapper cuts each 128-row group of a window into pieces
// of at most PIECE_BLOCKS blocks and about PIECE_WORK units of work (a kept
// (lane, word) pair and each of its nonzero bitmask bytes count one), with
// the list of K1 (ops/block_spmm.py:window_pieces, walk_tasks, plan_walk;
// the task layout of csrc/spmm_walk.cuh). A group without a block gets one
// empty piece, which writes its rows. The cut depends on the window's own
// blocks alone, so a window sums the same way in a window chunk as in the
// whole plan. The hub window of the ogbn-arxiv proxy (904 blocks) becomes
// many pieces of bounded work instead of one thread block's serial walk.
//
// Walk. One thread block per (task, column chunk; K13: and head group),
// four warps; warp i owns word 4 * group + i of the window (32 rows) and
// lane l row 32 * i + l of it, whose state (K9: m, l and the output
// columns; K13: the same for each head of its group; K10: the dq columns)
// stays in registers. The warp walks the piece's kept lanes of its word in
// lane order, with no barrier: each lane loads its unit's bitmask word and
// hind kAhead units ahead and a ballot queues the lanes with a bit. The
// queued items go in batches of nb (at most 32): lane i stages item i's
// rows, k[src] and the columns [v0, v0 + vw) of v[src], by cp.async into a
// ring of nbuf batches, the next batch in flight while the warp works on
// this one. Then 32 ballots turn the batch's words into each lane's mask of
// the items that hold a bit of its row, and every lane takes its own edges
// at once, in item order: a warp step serves up to 32 edges of 32 rows, so
// a batch costs as many steps as its busiest row has edges (a lane slot
// holds 1.56 bits on the arxiv proxy; one edge an item would leave 31 lanes
// idle). A row takes its edges in lane order and the piece's limit bounds
// it: a hub row is no longer one thread's loop while the block waits at a
// barrier, there is no row sort and no per-edge search, and every sum is
// taken in a fixed order, so float32 repeats bit for bit.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "attn_mh_common.cuh"
#include "spmm_walk.cuh"

namespace voltrix_attn_walk {

using voltrix_walk::kThreads;  // 128: four warps, one per 32-row word
using voltrix_walk::kWarps;
constexpr int kMaxBatch = 32;  // items a batch holds: one a lane
constexpr int kQueue = 128;    // queued items a warp holds: > 2 * kMaxBatch + 31
constexpr int kAhead = 4;      // units whose bitmask word and hind are loaded ahead
// shared memory a walk's thread block takes at most (walk_geometry): four
// thread blocks an SM
constexpr int kWalkSmem = 56 * 1024;
// the same for K13's walks of 4 or 8 heads, whose registers hold three
// thread blocks an SM
constexpr int kWideWalkSmem = 72 * 1024;
constexpr int kSmemMax = 232448;  // a thread block's shared memory on sm_90

// floats of a ring slot: k's row (padded to a multiple of 4), then vw
// columns of v, padded to an odd number of 16-byte units so that lanes
// reading the same column of different slots fall in different banks
__host__ __device__ inline int slot_floats(int dk, int vw) {
  const int sf = ((dk + 3) & ~3) + ((vw + 3) & ~3);
  return (sf / 4) % 2 ? sf : sf + 4;
}

// the warps' rings (nbuf batches of nb slots of sf floats each) and queues
// (`queues` arrays of kQueue ints: an item's word and source row, and with
// walk_items<true> its block)
__host__ __device__ inline int ring_smem_bytes(int sf, int nb, int nbuf, int queues = 2) {
  return kWarps * (nbuf * nb * sf + queues * kQueue) * 4;
}

__host__ __device__ inline int smem_bytes(int dk, int vw, int nb, int nbuf) {
  return ring_smem_bytes(slot_floats(dk, vw), nb, nbuf);
}

// rows of group g of a window that lie inside the window (block_h rows)
__device__ __forceinline__ int group_rows(int g, int words, int block_h) {
  return min(voltrix_walk::tile_rows(words - kWarps * g), block_h - kWarps * 32 * g);
}

// a[0..d) . b[0..d), a in global memory (16-byte aligned when vec, d % 4
// == 0) and b in shared memory (16-byte aligned) when kStagedB, else in
// global memory too (aligned like a). Four partial sums, one a column of
// each float4, added at the end: a shorter dependent chain than one sum.
template <bool kStagedB>
__device__ __forceinline__ float dot4(const float* __restrict__ a, const float* b, int d,
                                      bool vec) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (vec) {
    for (int c = 0; c < d; c += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a + c));
      const float4 y = kStagedB ? *reinterpret_cast<const float4*>(b + c)
                                : __ldg(reinterpret_cast<const float4*>(b + c));
      s0 = fmaf(x.x, y.x, s0);
      s1 = fmaf(x.y, y.y, s1);
      s2 = fmaf(x.z, y.z, s2);
      s3 = fmaf(x.w, y.w, s3);
    }
  } else {
    for (int c = 0; c < d; ++c) s0 = fmaf(__ldg(a + c), kStagedB ? b[c] : __ldg(b + c), s0);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc[c] += coef * s[c] for c < cw (s 16-byte aligned, padded to a
// multiple of 4 floats)
template <int kAcc>
__device__ __forceinline__ void axpy_staged(float coef, const float* s, int cw, float* acc) {
#pragma unroll
  for (int c = 0; c < kAcc; c += 4) {
    if (c < cw) {
      const float4 y = *reinterpret_cast<const float4*>(s + c);
      acc[c] = fmaf(coef, y.x, acc[c]);
      if (c + 1 < cw) acc[c + 1] = fmaf(coef, y.y, acc[c + 1]);
      if (c + 2 < cw) acc[c + 2] = fmaf(coef, y.z, acc[c + 2]);
      if (c + 3 < cw) acc[c + 3] = fmaf(coef, y.w, acc[c + 3]);
    }
  }
}

// dst[c] = acc[c] * mul for c < cw; 16-byte stores when vec (dst 16-byte
// aligned, cw % 4 == 0)
template <int kAcc>
__device__ __forceinline__ void store_row(float* dst, const float* acc, int cw, float mul,
                                          bool vec) {
#pragma unroll
  for (int c = 0; c < kAcc; c += 4) {
    if (c < cw) {
      if (vec) {
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[c] * mul, acc[c + 1] * mul, acc[c + 2] * mul, acc[c + 3] * mul);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < cw) dst[c + j] = acc[c + j] * mul;
        }
      }
    }
  }
}

// The walk of one warp over word `wi` of blocks [b0, b1). For each kept
// lane (a bit in the word), in lane order, lane i of the warp calls
// stage(slot, src) to copy item i's rows into a ring slot of `sf` floats
// (nbuf batches of nb slots; the copies go by cp.async or by plain shared
// stores, and land before the batch is read), then the warp calls
// edge(slot) on each lane whose row has a bit in the item (none where
// `active` is false), a lane's items in order; src is the lane's hind
// clipped into [0, nk), as the JAX gather clips it. q_word and q_src hold
// kQueue entries each. kBlk: the walk also queues each item's block in the
// kQueue ints after q_src and calls edge(slot, block) (the compute_dtype
// kernels of csrc/attn_fwd_bf16.cu, whose rounding point depends on the
// block's grid step); a lane's items come in block order.
template <bool kBlk = false, typename Stage, typename Edge>
__device__ __forceinline__ void walk_items(const uint32_t* __restrict__ bitmask,
                                           const int32_t* __restrict__ hind, int b0, int b1,
                                           int words, int wi, int block_w, int nk, int sf,
                                           int nb, int nbuf, float* ring, uint32_t* q_word,
                                           int32_t* q_src, bool active, Stage&& stage,
                                           Edge&& edge) {
  using namespace voltrix_walk;
  const int lane = threadIdx.x % 32;
  const int slices = (block_w + 31) / 32;
  const int units = (b1 - b0) * slices;
  // unit u is lane slice u % slices of block b0 + u / slices
  auto load_unit = [&](int u, uint32_t& word, int32_t& src) {
    word = 0u;
    src = 0;
    if (u < units) {
      const int64_t b = b0 + u / slices;
      const int j = (u % slices) * 32 + lane;
      if (j < block_w) {
        word = __ldg(bitmask + (b * words + wi) * block_w + j);
        src = min(max(__ldg(hind + b * block_w + j), 0), nk - 1);
      }
    }
  };
  uint32_t next_word[kAhead];
  int32_t next_src[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load_unit(a, next_word[a], next_src[a]);
  int u = 0, produced = 0;
  // queue the lanes of the next unit with a bit in the word, in lane order
  auto produce = [&]() {
    const bool keep = next_word[0] != 0u;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = (produced + __popc(ballot & ((1u << lane) - 1u))) % kQueue;
      q_word[pos] = next_word[0];
      q_src[pos] = next_src[0];
      if constexpr (kBlk) q_src[kQueue + pos] = b0 + u / slices;
    }
    __syncwarp();
    produced += __popc(ballot);
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) {
      next_word[a] = next_word[a + 1];
      next_src[a] = next_src[a + 1];
    }
    load_unit(u + kAhead, next_word[kAhead - 1], next_src[kAhead - 1]);
    ++u;
  };
  // queue items until item i exists or the units are spent (warp-uniform)
  auto ensure = [&](int i) {
    while (produced <= i && u < units) produce();
  };
  // lane i stages item first + i into slot i of batch buffer `buf`; one
  // commit group per call
  auto issue = [&](int first, int buf) {
    const int i = first + lane;
    if (lane < nb && i < produced) stage(ring + (buf * nb + lane) * sf, (int64_t)q_src[i % kQueue]);
    cp_async_commit();
  };
  ensure(nb - 1);
  issue(0, 0);
  for (int base = 0, it = 0; base < produced; base += nb, ++it) {
    const int buf = nbuf > 1 ? it & 1 : 0;
    if (nbuf > 1) {  // the next batch in flight while this one is summed
      ensure(base + 2 * nb - 1);
      issue(base + nb, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this batch have landed
    // this lane's row's bit in each of the batch's words: 32 ballots
    const uint32_t word = lane < min(nb, produced - base) ? q_word[(base + lane) % kQueue] : 0u;
    uint32_t mask = 0u;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const uint32_t b = __ballot_sync(0xffffffffu, (word >> r) & 1u);
      if (lane == r) mask = b;
    }
    if (!active) mask = 0u;
    const float* slots = ring + buf * nb * sf;
    while (mask) {
      const int i = __ffs(static_cast<int>(mask)) - 1;
      mask &= mask - 1u;
      if constexpr (kBlk) {
        edge(slots + i * sf, q_src[kQueue + (base + i) % kQueue]);
      } else {
        edge(slots + i * sf);
      }
    }
    __syncwarp();  // the batch is read before a later batch reuses its slots
    if (nbuf == 1) {
      ensure(base + 2 * nb - 1);
      issue(base + nb, 0);
    }
  }
  cp_async_wait<0>();
}

// walk_items with slots of k[src] (dk floats) and v[src][v0, v0 + vw)
// (slot_floats(dk, vw) floats), for K9 and K10. vec: 16-byte copies (dk,
// v0 and vw multiples of 4, k and v 16-byte aligned), else 4-byte ones.
template <typename Edge>
__device__ __forceinline__ void walk_word(const uint32_t* __restrict__ bitmask,
                                          const int32_t* __restrict__ hind, int b0, int b1,
                                          int words, int wi, int block_w, int nk,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v, int dk, int dv, int v0,
                                          int vw, bool vec, int nb, int nbuf, float* ring,
                                          uint32_t* q_word, int32_t* q_src, bool active,
                                          Edge&& edge) {
  using namespace voltrix_walk;
  const int kpad = (dk + 3) & ~3;
  walk_items(bitmask, hind, b0, b1, words, wi, block_w, nk, slot_floats(dk, vw), nb, nbuf, ring,
             q_word, q_src, active,
             [&](float* slot, int64_t src) {
               const float* krow = k + src * dk;
               const float* vrow = v + src * dv + v0;
               if (vec) {
                 for (int c = 0; c < dk; c += 4) cp_async16(slot + c, krow + c);
                 for (int c = 0; c < vw; c += 4) cp_async16(slot + kpad + c, vrow + c);
               } else {
                 for (int c = 0; c < dk; ++c) cp_async4(slot + c, krow + c);
                 for (int c = 0; c < vw; ++c) cp_async4(slot + kpad + c, vrow + c);
               }
             },
             edge);
}

// The batch (nb items, at most kMaxBatch) and buffers (nbuf, 1 or 2) of a
// walk whose slots hold sf floats: the largest batch whose two buffers fit
// `budget` bytes with the queues, else one buffer, else the same within
// all of a thread block's shared memory; nb 0 when nothing fits.
inline void walk_geometry_sf(int sf, int budget, int* nb, int* nbuf, int queues = 2) {
  for (const int cap : {budget, kSmemMax}) {
    for (*nbuf = 2; *nbuf >= 1; --*nbuf) {
      for (*nb = kMaxBatch; *nb >= 1; *nb /= 2) {
        if (ring_smem_bytes(sf, *nb, *nbuf, queues) <= cap) return;
      }
    }
  }
  *nb = 0;
}

// walk_geometry_sf for slots of slot_floats(dk, vw) floats within kWalkSmem
inline void walk_geometry(int dk, int vw, int* nb, int* nbuf) {
  walk_geometry_sf(slot_floats(dk, vw), kWalkSmem, nb, nbuf);
}

// --- the slots of the multi-head walks (K13, K14, K15) ----------------------

// elements of a row of n values of `esize` bytes, padded to 16 bytes
__host__ __device__ inline int pad16(int n, int esize) {
  const int per = 16 / esize;
  return (n + per - 1) / per * per;
}

// a head stack's strides in elements: head h's row r starts at h * head +
// r * row (the projections' node-major views, or a contiguous stack)
struct Strides {
  int64_t head, row;
};

// floats of a multi-head ring slot: a row of da values of each of hg heads,
// then a row of db values of each, each row padded to 16 bytes (K13: k and
// a column chunk of v; K14: k and v; K15: q and dO), then `extra` floats
// (K15: lse and D of each head), padded to an odd number of 16-byte units
// (lanes reading the same place of different slots fall in different banks)
__host__ __device__ inline int mh_slot_floats(int da, int db, int hg, int esize, int extra = 0) {
  const int units = hg * (pad16(da, esize) + pad16(db, esize)) * esize / 16 + (extra + 3) / 4;
  return 4 * (units % 2 ? units : units + 1);
}

// four staged values as floats (p 16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ float4 staged4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 staged4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// a row of n values into a slot: 16-byte cp.async when vec (n a multiple
// of 16 bytes, src 16-byte aligned), else 4-byte cp.async (float) or plain
// shared stores (bf16), which land before the warp's next __syncwarp
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    for (int c = 0; c < n; c += 4) voltrix_walk::cp_async16(dst + c, src + c);
  } else {
    for (int c = 0; c < n; ++c) voltrix_walk::cp_async4(dst + c, src + c);
  }
}
__device__ __forceinline__ void stage_row(__nv_bfloat16* dst, const __nv_bfloat16* src, int n,
                                          bool vec) {
  if (vec) {
    for (int c = 0; c < n; c += 8) voltrix_walk::cp_async16(dst + c, src + c);
  } else {
    for (int c = 0; c < n; ++c) dst[c] = src[c];
  }
}

// q[0..dk) (registers, zero past dk) . s[0..dk) (staged): four partial
// sums, one a column of each group of four, added at the end (K13's scores)
template <int kQ, typename T>
__device__ __forceinline__ float dot_regs(const float* qr, const T* s, int dk) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c = 0; c < kQ; c += 4) {
    if (c < dk) {
      const float4 y = staged4(s + c);
      s0 = fmaf(qr[c], y.x, s0);
      if (c + 1 < dk) s1 = fmaf(qr[c + 1], y.y, s1);
      if (c + 2 < dk) s2 = fmaf(qr[c + 2], y.z, s2);
      if (c + 3 < dk) s3 = fmaf(qr[c + 3], y.w, s3);
    }
  }
  return (s0 + s1) + (s2 + s3);
}

// q[0..dk) read through __ldg (16-byte loads when vec) . s[0..dk) (staged),
// summed in the order of dot_regs
template <typename T>
__device__ __forceinline__ float dot_ldg(const float* __restrict__ q, const T* s, int dk,
                                         bool vec) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int c = 0; c < dk; c += 4) {
    float4 x;
    if (vec) {
      x = __ldg(reinterpret_cast<const float4*>(q + c));
    } else {
      x.x = __ldg(q + c);
      x.y = c + 1 < dk ? __ldg(q + c + 1) : 0.f;
      x.z = c + 2 < dk ? __ldg(q + c + 2) : 0.f;
      x.w = c + 3 < dk ? __ldg(q + c + 3) : 0.f;
    }
    const float4 y = staged4(s + c);
    s0 = fmaf(x.x, y.x, s0);
    if (c + 1 < dk) s1 = fmaf(x.y, y.y, s1);
    if (c + 2 < dk) s2 = fmaf(x.z, y.z, s2);
    if (c + 3 < dk) s3 = fmaf(x.w, y.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// K14's and K15's dots. x[0..d) (registers, zero past d) . s[0..d)
// (staged): four partial sums, one a column of each group of four, added
// at the end (dP); with kChains 1 one chain of fmas in column order (the
// scores: a score within rounding of 0 takes the slope of leaky_relu that
// the sum in that order gives it, as K14's and K15's first kernels did)
template <int kQ, int kChains, typename T>
__device__ __forceinline__ float bwd_dot_regs(const float* x, const T* s, int d) {
  constexpr int k1 = kChains > 1 ? 1 : 0, k2 = kChains > 1 ? 2 : 0, k3 = kChains > 1 ? 3 : 0;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kQ; c += 4) {
    if (c < d) {
      const float4 y = staged4(s + c);
      a[0] = fmaf(x[c], y.x, a[0]);
      if (c + 1 < d) a[k1] = fmaf(x[c + 1], y.y, a[k1]);
      if (c + 2 < d) a[k2] = fmaf(x[c + 2], y.z, a[k2]);
      if (c + 3 < d) a[k3] = fmaf(x[c + 3], y.w, a[k3]);
    }
  }
  return kChains > 1 ? (a[0] + a[1]) + (a[2] + a[3]) : a[0];
}

// x[0..d) read through __ldg (float or bf16; four values a load when vec:
// d % 4 == 0, x 16-byte aligned for float, 8 for bf16) . s[0..d) (staged),
// summed in the order of bwd_dot_regs<kQ, kChains>
template <int kChains, typename U, typename T>
__device__ __forceinline__ float bwd_dot_ldg(const U* __restrict__ x, const T* s, int d, bool vec) {
  using voltrix_attn::to_f;
  constexpr int k1 = kChains > 1 ? 1 : 0, k2 = kChains > 1 ? 2 : 0, k3 = kChains > 1 ? 3 : 0;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {  // whole groups of four: no test per value
    for (int c = 0; c < d; c += 4) {
      const float4 b = voltrix_attn::load4(x + c);
      const float4 y = staged4(s + c);
      a[0] = fmaf(b.x, y.x, a[0]);
      a[k1] = fmaf(b.y, y.y, a[k1]);
      a[k2] = fmaf(b.z, y.z, a[k2]);
      a[k3] = fmaf(b.w, y.w, a[k3]);
    }
  } else {
    for (int c = 0; c < d; c += 4) {
      const float4 y = staged4(s + c);
      a[0] = fmaf(to_f(__ldg(x + c)), y.x, a[0]);
      if (c + 1 < d) a[k1] = fmaf(to_f(__ldg(x + c + 1)), y.y, a[k1]);
      if (c + 2 < d) a[k2] = fmaf(to_f(__ldg(x + c + 2)), y.z, a[k2]);
      if (c + 3 < d) a[k3] = fmaf(to_f(__ldg(x + c + 3)), y.w, a[k3]);
    }
  }
  return kChains > 1 ? (a[0] + a[1]) + (a[2] + a[3]) : a[0];
}

// acc[c] += coef * s[c] for the groups of four c < cw (s staged, padded to
// 16 bytes; columns of the last group past cw take what the padding holds
// and are never stored)
template <int kAcc, typename T>
__device__ __forceinline__ void axpy_typed(float coef, const T* s, int cw, float* acc) {
#pragma unroll
  for (int c = 0; c < kAcc; c += 4) {
    if (c < cw) {
      const float4 y = staged4(s + c);
      acc[c] = fmaf(coef, y.x, acc[c]);
      acc[c + 1] = fmaf(coef, y.y, acc[c + 1]);
      acc[c + 2] = fmaf(coef, y.z, acc[c + 2]);
      acc[c + 3] = fmaf(coef, y.w, acc[c + 3]);
    }
  }
}

// thread blocks an SM holds at least, by head group of two or more:
// registers capped to fit them, which timed faster at path G's layer 1 on
// the H100 than the registers the sums ask for (K13 in attn_fwd.cu, K14 in
// attn_mh_dq.cu); 8 heads keep all they need (a group of one head is left
// to ptxas, whose choice timed faster still: a kernel with no minimum)
__host__ __device__ constexpr int mh_min_blocks(int hg) {
  return hg >= 8 ? 2 : hg == 4 ? 3 : 4;
}

// Raises the kernel's dynamic shared memory limit to `smem` bytes.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace voltrix_attn_walk

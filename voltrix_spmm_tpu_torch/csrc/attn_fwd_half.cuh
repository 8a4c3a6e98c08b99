// Kernels K9 and K13 under compute_dtype=bfloat16 or float16, for sm_90a:
// fused graph attention, forward, with the JAX package's rounding points
// (voltrix_spmm_tpu/ops/attention.py:121-143, attention_mh.py:168-190). For
// head h, destination row r and its in-neighbours l, with rnd the rounding
// to the compute type R (bf16 or float16, to nearest even):
//
//   raw = rnd(q[r]) . rnd(k[l])          (each product exact, summed in float32)
//   s = leaky_relu(scale * raw, slope)
//   p = exp(s - M),  l_r = sum p,  out[r] = sum rnd(p) rnd(v[l]) / l_r
//
// Replaces voltrix_spmm_tpu/ops/attention.py:_attn_fwd_kernel and
// attention_mh.py:_attn_fwd_mh_kernel at compute_dtype=jnp.bfloat16 and
// jnp.float16. K9 is this K13 at one head with float32 planes
// (ops/_attn_core.py:fwd_half_kernel launches both, on each one's own work
// list). A product of two float16 values is exact in float32 as one of two
// bf16 values is (11 + 11 significant bits fit in 24), so the float16
// instantiations keep the bf16 design whole. Under float16 a bf16 plane's k
// and v are rounded too (past 65,504 to inf, small values to subnormals),
// and p below 6.1e-5 becomes a float16 subnormal, which the build keeps (no
// fast math: jit/compiler.py). Each compute type builds from a source of
// its own, attn_fwd_bf16.cu and attn_fwd_f16.cu, which instantiate this
// header's `fwd_half` for their R: the two builds run side by side, each as
// long as the one source took with bf16 alone.
//
// The rounding point. p is rounded to bf16 after exp(s - M), so its value
// depends on M. On the TPU, M is the row's running maximum after each grid
// step of the online softmax: the row's largest score over the window's
// blocks up to the end of the edge's group of block_unroll blocks. Rounding
// against another maximum (the row's final one, or a maximum moved edge by
// edge as csrc/attn_fwd.cu does) moves out by ~1e-3 of max|out| on a 260-node
// graph, past the float32 tolerance, so these kernels take the TPU's M:
//
// 1. attn_block_max_kernel walks each piece of the work list once (K13's
//    row walk of attn_walk.cuh, slots holding k rows only) and writes, for
//    each head, block and row of the window, the row's largest score over
//    the block's edges (kNeg where it has none): bmax (heads, blocks,
//    block_h). Each (block, row) lies in exactly one piece, so each entry is
//    written once, with no atomic.
// 2. attn_fwd_bf16_kernel walks the piece again. A lane (a row) starts
//    from M = the largest bmax of the window's blocks before the piece (the
//    blocks before b0 whose window_of_block is the piece's), and at the
//    first edge of each grid step takes M = max(M, the bmax of the step's
//    blocks), rescaling l and acc by exp(M_old - M_new) as the TPU's corr
//    does; each edge adds p = exp(s - M) <= 1 to l unrounded and bf16(p)
//    bf16(v) to acc. A cut group's pieces leave their (M, l, acc) shares
//    and attn_fwd_merge.cuh merges them in piece order. A grid step is the
//    TPU's: block_unroll blocks from a multiple of block_unroll (the
//    preprocessor pads every window to whole steps, so a step lies in one
//    window).
//
// Both kernels sum a score in one fma chain in column order (each product of
// two values of type R is exact), so they find the same scores, and the
// plain version (ops/_attn_core.py:_fwd_plain_half) sums them in the same
// order.
// exp is expf (not __expf), the function torch.exp runs on the card, so the
// plain version on the card rounds the same p. No atomics.
//
// Bound: as K13's, per head, plus the first walk's scores (2 dk flops an
// edge) and bmax's bytes (heads x blocks x block_h floats, written once and
// read about twice). Two walks where K13 takes one: on an NVIDIA H100 80GB
// HBM3 at 700 W, the flash GAT's plan of the ogbn-arxiv proxy takes 2.938 /
// 1.380 ms at H 8 x d 8 / H 1 x d 40 with float32 planes (K13 0.932 / 0.595
// in turns), 2.314 / 1.035 ms with bf16 planes, and K9 0.792 / 1.364 ms at d
// 8 / 40 (0.246 / 0.638).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "attn_fwd_merge.cuh"
#include "attn_walk.cuh"

namespace {

using voltrix_attn::act;
using voltrix_attn::kEmptyLse;
using voltrix_attn::kNeg;
using namespace voltrix_attn_walk;
using voltrix_fwd_merge::launch_merge;
using voltrix_walk::kB0;
using voltrix_walk::kB1;
using voltrix_walk::kG;
using voltrix_walk::kRank;
using voltrix_walk::kSlot;
using voltrix_walk::kTaskInts;
using voltrix_walk::kW;
using voltrix_walk::tile_rows;

constexpr int kQueues = 3;  // a walk_items<true> queue: word, source row, block

// The arguments both kernels take: the plan's arrays and the work list, the
// stacks and their strides, the geometry, bmax, and the walk's batch
#define VOLTRIX_BF16_PARAMS                                                                 \
  const uint32_t *__restrict__ bitmask, /* (B, words, K) */                                 \
      const int32_t *__restrict__ hind,  /* (B, K) */                                       \
      const int32_t *__restrict__ wob,   /* (B,) window_of_block */                         \
      const int32_t *__restrict__ tasks, /* (num_tasks, kTaskInts) */                       \
      const float *__restrict__ q,       /* (H, nq, dk), strides qs */                      \
      const T *__restrict__ k,           /* (H, nk, dk), strides ks */                      \
      const T *__restrict__ v,           /* (H, nk, dv), strides vs */                      \
      float *__restrict__ bmax,          /* (H, B, block_h) */                              \
      float *__restrict__ out,           /* (H, nq, dv) */                                  \
      float *__restrict__ lse,           /* (H, padded) */                                  \
      float *__restrict__ ws_ml,         /* (slots, H, tile rows, 2): m, l */               \
      float *__restrict__ ws_acc,        /* (slots, H, tile rows, dv) */                    \
      int heads, int words, int block_h, int block_w, int unroll, int num_blocks, int nq,  \
      int nk, int dk, int dv, int64_t padded, float scale, float slope, int vec_k,          \
      int vec_v, Strides qs, Strides ks, Strides vs, int nb, int nbuf

// Pass 1: bmax[h, b, r] = the largest score of row r's edges in block b
// (kNeg without one), for every block of each piece and every row of its
// group that exists. One thread block per (task and head group); a slot
// holds the item's k row of every head of the group. R: the compute type.
template <typename T, typename R, int HG>
__global__ void __launch_bounds__(kThreads) attn_block_max_kernel(VOLTRIX_BF16_PARAMS) {
  constexpr int kQ = 64 / HG;
  extern __shared__ __align__(16) float smem[];
  const int ngroups = (heads + HG - 1) / HG;
  const int* task = tasks + (int64_t)(blockIdx.x / ngroups) * kTaskInts;
  const int w = task[kW], g = task[kG], b0 = task[kB0], b1 = task[kB1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= min(kWarps, words - kWarps * g)) return;
  const int h0 = (blockIdx.x % ngroups) * HG;
  const int hg = min(HG, heads - h0), hgl = min(HG, heads);
  constexpr int esize = sizeof(T);
  const int kpad = pad16(dk, esize);
  const int sf = mh_slot_floats(dk, 0, hgl, esize);
  const int ring_floats = nbuf * nb * sf;
  float* ring = smem + warp * ring_floats;
  uint32_t* q_word =
      reinterpret_cast<uint32_t*>(smem + kWarps * ring_floats) + warp * kQueues * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;                  // the lane's row in the group's tile
  const int rw = kWarps * 32 * g + r;              // ... in the window
  const bool in_window = r < group_rows(g, words, block_h);
  const int64_t row = (int64_t)w * block_h + rw;
  const bool has_row = in_window && row < nq;
  const int64_t rr = has_row ? row : 0;
  const bool q_regs = dk <= kQ;
  float qr[HG][kQ];
  float mx[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const float* qh = q + (h0 + min(j, hg - 1)) * qs.head + rr * qs.row;
#pragma unroll
    for (int c = 0; c < kQ; ++c) qr[j][c] = q_regs && c < dk ? round16<R>(__ldg(qh + c)) : 0.f;
    mx[j] = kNeg;
  }
  // bmax of blocks [from, to) for this lane's row: the block `cur`'s maxima,
  // kNeg for the others
  auto put = [&](int from, int to, int cur) {
    for (int b = from; b < to; ++b) {
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        if (j < hg) {
          bmax[((int64_t)(h0 + j) * num_blocks + b) * block_h + rw] = b == cur ? mx[j] : kNeg;
        }
      }
    }
  };
  int cur = b0 - 1;  // the block of the lane's last edge
  walk_items<true>(
      bitmask, hind, b0, b1, words, kWarps * g + warp, block_w, nk, sf, nb, nbuf, ring, q_word,
      q_src, has_row,
      [&](float* slot, int64_t src) {
        T* st = reinterpret_cast<T*>(slot);
        for (int j = 0; j < hg; ++j) {
          stage_row(st + j * kpad, k + (h0 + j) * ks.head + src * ks.row, dk, vec_k);
        }
      },
      [&](const float* s, int blk) {
        if (blk != cur) {  // the last block's maxima, kNeg for the blocks between
          put(max(cur, b0), blk, cur);
#pragma unroll
          for (int j = 0; j < HG; ++j) mx[j] = kNeg;
          cur = blk;
        }
        const T* st = reinterpret_cast<const T*>(s);
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* kst = st + jj * kpad;
          const float raw =
              q_regs ? score_regs<kQ, T, R>(qr[j], kst, dk)
                     : score_ldg<float, T, R>(q + (h0 + jj) * qs.head + rr * qs.row, kst, dk);
          mx[j] = fmaxf(mx[j], act(raw, scale, slope));
        }
      });
  if (has_row) put(max(cur, b0), b1, cur);
}

// Pass 2: the online softmax at the TPU's grid steps (see the file's
// comment). One thread block per (task and head group, column chunk); a
// slot holds the item's k row and v column chunk of every head of the
// group in the plane's type T. R: the compute type.
template <typename T, typename R, int HG, int kAcc>
__global__ void __launch_bounds__(kThreads) attn_fwd_bf16_kernel(VOLTRIX_BF16_PARAMS) {
  constexpr int kQ = 64 / HG;
  extern __shared__ __align__(16) float smem[];
  const int ngroups = (heads + HG - 1) / HG;
  const int* task = tasks + (int64_t)(blockIdx.x / ngroups) * kTaskInts;
  const int w = task[kW], g = task[kG], b0 = task[kB0];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= min(kWarps, words - kWarps * g)) return;
  const int h0 = (blockIdx.x % ngroups) * HG;
  const int hg = min(HG, heads - h0), hgl = min(HG, heads);
  const int c0 = blockIdx.y * kAcc;
  const int cw = min(kAcc, dv - c0);
  const int vw = min(kAcc, dv);  // the widest chunk, which sizes the slots
  constexpr int esize = sizeof(T);
  const int kpad = pad16(dk, esize), vpad = pad16(vw, esize);
  const int sf = mh_slot_floats(dk, vw, hgl, esize);
  const int ring_floats = nbuf * nb * sf;
  float* ring = smem + warp * ring_floats;
  uint32_t* q_word =
      reinterpret_cast<uint32_t*>(smem + kWarps * ring_floats) + warp * kQueues * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;
  const int rw = kWarps * 32 * g + r;
  const bool in_window = r < group_rows(g, words, block_h);
  const int64_t row = (int64_t)w * block_h + rw;
  const bool has_row = in_window && row < nq;
  const int64_t rr = has_row ? row : 0;
  const bool q_regs = dk <= kQ;
  float qr[HG][kQ];
  float m[HG], l[HG], acc[HG][kAcc];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const float* qh = q + (h0 + min(j, hg - 1)) * qs.head + rr * qs.row;
#pragma unroll
    for (int c = 0; c < kQ; ++c) qr[j][c] = q_regs && c < dk ? round16<R>(__ldg(qh + c)) : 0.f;
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[j][c] = 0.f;
  }
  // the largest bmax of blocks [from, to) into m
  auto take = [&](int from, int to) {
    for (int b = from; b < to; ++b) {
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        const int jj = min(j, hg - 1);
        m[j] = fmaxf(m[j], bmax[((int64_t)(h0 + jj) * num_blocks + b) * block_h + rw]);
      }
    }
  };
  if (has_row) {  // the window's blocks before the piece
    for (int b = b0 - 1; b >= 0 && __ldg(wob + b) == w; --b) take(b, b + 1);
  }
  int step = -1;  // the first block of the grid step of the lane's last edge

  walk_items<true>(
      bitmask, hind, b0, task[kB1], words, kWarps * g + warp, block_w, nk, sf, nb, nbuf, ring,
      q_word, q_src, has_row,
      [&](float* slot, int64_t src) {
        T* st = reinterpret_cast<T*>(slot);
        for (int j = 0; j < hg; ++j) {
          stage_row(st + j * kpad, k + (h0 + j) * ks.head + src * ks.row, dk, vec_k);
          stage_row(st + hgl * kpad + j * vpad, v + (h0 + j) * vs.head + src * vs.row + c0, cw,
                    vec_v);
        }
      },
      [&](const float* s, int blk) {
        const int first = blk / unroll * unroll;
        if (first != step) {  // a new grid step: M over its blocks, as the TPU's corr
          float m_old[HG];
#pragma unroll
          for (int j = 0; j < HG; ++j) m_old[j] = m[j];
          take(first, first + unroll);
#pragma unroll
          for (int j = 0; j < HG; ++j) {
            const float corr = expf(m_old[j] - m[j]);
            l[j] *= corr;
#pragma unroll
            for (int c = 0; c < kAcc; ++c) acc[j][c] *= corr;
          }
          step = first;
        }
        const T* st = reinterpret_cast<const T*>(s);
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* kst = st + jj * kpad;
          const float raw =
              q_regs ? score_regs<kQ, T, R>(qr[j], kst, dk)
                     : score_ldg<float, T, R>(q + (h0 + jj) * qs.head + rr * qs.row, kst, dk);
          const float p = expf(act(raw, scale, slope) - m[j]);
          l[j] += p;
          const float pb = round16<R>(p);
          const T* vst = st + hgl * kpad + jj * vpad;
#pragma unroll
          for (int c = 0; c < kAcc; c += 4) {
            if (c < cw) {
              const float4 y = staged4_bf16<T, R>(vst + c);
              acc[j][c] = fmaf(pb, y.x, acc[j][c]);
              acc[j][c + 1] = fmaf(pb, y.y, acc[j][c + 1]);
              acc[j][c + 2] = fmaf(pb, y.z, acc[j][c + 2]);
              acc[j][c + 3] = fmaf(pb, y.w, acc[j][c + 3]);
            }
          }
        }
      });

  const bool vec_out = dv % 4 == 0 && cw % 4 == 0;
  const int tile = tile_rows(words);
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    if (j < hg) {
      const int h = h0 + j;
      if (task[kSlot] < 0) {  // the group is this one piece: finish its rows
        if (has_row) {
          store_row<kAcc>(out + ((int64_t)h * nq + row) * dv + c0, acc[j], cw,
                          1.f / fmaxf(l[j], 1e-30f), vec_out);
        }
        if (blockIdx.y == 0 && in_window) {
          lse[h * padded + row] = l[j] > 0.f ? m[j] + logf(fmaxf(l[j], 1e-30f)) : kEmptyLse;
        }
      } else if (in_window) {  // a share of a cut group, into the piece's slot
        const int64_t sh = ((int64_t)(task[kSlot] + task[kRank]) * heads + h) * tile + r;
        if (blockIdx.y == 0) {
          ws_ml[2 * sh] = m[j];
          ws_ml[2 * sh + 1] = l[j];
        }
        store_row<kAcc>(ws_acc + sh * dv + c0, acc[j], cw, 1.f, vec_out);
      }
    }
  }
}

template <typename T, typename R, int HG, int kAcc>
int launch(const void* merges, int num_tasks, int num_merges, VOLTRIX_BF16_PARAMS,
           cudaStream_t s) {
  const int ngroups = (heads + HG - 1) / HG;
  const int hgl = min(HG, heads);
  // pass 1: k rows only
  int nb1, nbuf1;
  const int sf1 = mh_slot_floats(dk, 0, hgl, sizeof(T));
  walk_geometry_sf(sf1, HG >= 4 ? kWideWalkSmem : kWalkSmem, &nb1, &nbuf1, kQueues);
  // pass 2: k rows and a column chunk of v
  int nb2, nbuf2;
  const int sf2 = mh_slot_floats(dk, min(kAcc, dv), hgl, sizeof(T));
  walk_geometry_sf(sf2, HG >= 4 ? kWideWalkSmem : kWalkSmem, &nb2, &nbuf2, kQueues);
  if (nb1 == 0 || nb2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto first = attn_block_max_kernel<T, R, HG>;
  auto second = attn_fwd_bf16_kernel<T, R, HG, kAcc>;
  const int smem1 = ring_smem_bytes(sf1, nb1, nbuf1, kQueues);
  const int smem2 = ring_smem_bytes(sf2, nb2, nbuf2, kQueues);
  cudaError_t err = allow_smem(first, smem1);
  if (err == cudaSuccess) err = allow_smem(second, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  first<<<num_tasks * ngroups, kThreads, smem1, s>>>(
      bitmask, hind, wob, tasks, q, k, v, bmax, out, lse, ws_ml, ws_acc, heads, words, block_h,
      block_w, unroll, num_blocks, nq, nk, dk, dv, padded, scale, slope, vec_k, vec_v, qs, ks,
      vs, nb1, nbuf1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  second<<<dim3(num_tasks * ngroups, (dv + kAcc - 1) / kAcc), kThreads, smem2, s>>>(
      bitmask, hind, wob, tasks, q, k, v, bmax, out, lse, ws_ml, ws_acc, heads, words, block_h,
      block_w, unroll, num_blocks, nq, nk, dk, dv, padded, scale, slope, vec_k, vec_v, qs, ks,
      vs, nb2, nbuf2);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_merges == 0) return static_cast<int>(err);
  return launch_merge(merges, ws_ml, ws_acc, out, lse, num_merges, heads, words,
                      block_h, nq, dv, padded, s);
}
#undef VOLTRIX_BF16_PARAMS

// K13 at compute type R (K9: heads = 1, float32 planes): the checks and the
// dispatch of the entry points voltrix_attn_fwd_bf16 (attn_fwd_bf16.cu) and
// voltrix_attn_fwd_f16 (attn_fwd_f16.cu), whose arguments it takes
template <typename R>
int fwd_half(const void* bitmask, const void* hind, const void* window_of_block,
             const void* tasks, const void* merges, const void* q, const void* k, const void* v,
             void* bmax, void* out, void* lse, void* ws_ml, void* ws_acc, int num_tasks,
             int num_merges, int heads, int hg, int words, int block_h, int block_w, int unroll,
             int num_blocks, int nq, int nk, int dk, int dv, int padded, int acc, int bf16,
             float scale, float slope, int vec_k, int vec_v, long long q_head, long long q_row,
             long long k_head, long long k_row, long long v_head, long long v_row,
             void* stream) {
  if (num_tasks <= 0 || num_merges < 0 || heads <= 0 || hg <= 0 ||
      (int64_t)num_tasks * ((heads + hg - 1) / hg) > INT32_MAX || words <= 0 ||
      words * 32 < block_h || block_h <= 0 || block_w <= 0 || unroll <= 0 || num_blocks <= 0 ||
      nq <= 0 || nk <= 0 || dk < 0 || dv <= 0 || padded < nq || acc <= 0 ||
      (dv + acc - 1) / acc > 65535 || (num_merges && !ws_ml) || q_head < 0 || q_row < 0 ||
      k_head < 0 || k_row < 0 || v_head < 0 || v_row < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_head, q_row}, ks{k_head, k_row}, vs{v_head, v_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bm = static_cast<const uint32_t*>(bitmask);
  const auto* hi = static_cast<const int32_t*>(hind);
  const auto* wb = static_cast<const int32_t*>(window_of_block);
  const auto* tk = static_cast<const int32_t*>(tasks);
  const auto* qf = static_cast<const float*>(q);
  auto* bx = static_cast<float*>(bmax);
  auto* o = static_cast<float*>(out);
  auto* ls = static_cast<float*>(lse);
  auto* wm = static_cast<float*>(ws_ml);
  auto* wa = static_cast<float*>(ws_acc);
#define VOLTRIX_BF16(T, HG, N)                                                              \
  if (hg == HG && acc == N) {                                                               \
    return launch<T, R, HG, N>(                                                             \
        merges, num_tasks, num_merges, bm, hi, wb, tk, qf, static_cast<const T*>(k),        \
        static_cast<const T*>(v), bx, o, ls, wm, wa, heads, words, block_h, block_w, unroll, \
        num_blocks, nq, nk, dk, dv, padded, scale, slope, vec_k, vec_v, qs, ks, vs, 0, 0, s); \
  }
#define VOLTRIX_BF16_PAIRS(T)                                                               \
  VOLTRIX_BF16(T, 1, 8)                                                                     \
  VOLTRIX_BF16(T, 1, 16)                                                                    \
  VOLTRIX_BF16(T, 1, 32)                                                                    \
  VOLTRIX_BF16(T, 1, 40)                                                                    \
  VOLTRIX_BF16(T, 1, 64)                                                                    \
  VOLTRIX_BF16(T, 2, 8)                                                                     \
  VOLTRIX_BF16(T, 2, 16)                                                                    \
  VOLTRIX_BF16(T, 2, 40)                                                                    \
  VOLTRIX_BF16(T, 4, 8)                                                                     \
  VOLTRIX_BF16(T, 4, 16)                                                                    \
  VOLTRIX_BF16(T, 8, 8)
  // the (head group, column chunk) pairs of dispatch_mh (ops/attention_mh.py:MH_ACC_WIDTHS),
  // for each plane type T
  if (bf16) {
    VOLTRIX_BF16_PAIRS(__nv_bfloat16)
  } else {
    VOLTRIX_BF16_PAIRS(float)
  }
#undef VOLTRIX_BF16_PAIRS
#undef VOLTRIX_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Kernel K9: single-head fused graph attention, forward, for sm_90a. For
// destination row r with in-neighbours l (the plan's set bits):
//
//   s = leaky_relu(scale * q[r] . k[l], slope)
//   out[r] = sum_l exp(s - m_r) v[l] / max(l_r, 1e-30),   lse[r] = m_r + log(l_r)
//
// with m_r the row's largest score and l_r = sum_l exp(s - m_r). A row with
// no edges, and every row of an empty window, gets out 0 and lse 1e30.
//
// Replaces voltrix_spmm_tpu/ops/attention.py:_attn_fwd_kernel together with
// the pair-packed [k || v] gather it consumes. The TPU expands each grid
// step's bitmask to a (block_h, U*K) tile, scores it on the MXU and carries
// an online softmax (m, l, acc) from grid step to grid step of one window.
// Here q (nq, dk), k and v (nk, d) are float32, read as they are, k and v
// gathered by hind inside the kernel.
//
// Design. The row walk of attn_walk.cuh over K1's work list: a thread block
// per (piece of a 128-row group, chunk of up to kAcc columns of v), a warp
// per 32-row word, a lane per row, which keeps its row's online softmax (m,
// l and kAcc columns of acc) in registers and folds in its edges in lane
// order: a score above m rescales l and acc by exp(m - s). A group that is
// one piece finishes its rows: out = acc / l and lse. A group cut into
// several pieces leaves each piece's share (m, l, acc) in a workspace slot,
// and a second kernel, attn_fwd_merge_kernel (csrc/attn_fwd_merge.cuh),
// merges the shares in a fixed order: a warp per row takes the row's
// largest share maximum M once, its lanes rescale the shares by
// exp(m_share - M), four columns a lane, the lane groups over the shares
// each in piece order and then a fixed shuffle tree, so the output is the
// same in every run. No float atomics; no
// double sums (the order is fixed, so float32 repeats).
//
// Bound. Per edge 2 * (dk + dv) flops and an exp; the bytes are the plan,
// q, k, v, out and lse once each. The gathers of k and v rows, one per
// kept (lane, word) pair, and the hub window, whose hub row takes an edge
// in nearly every queued lane, one a step, separate it from the bound.
//
// Kernel K13, in the same file: multi-head fused graph attention, forward,
// the same function for each head h of q (H, nq, dk), k (H, nk, dk) and v
// (H, nk, dv), with lse (H, padded rows). It replaces
// voltrix_spmm_tpu/ops/attention_mh.py:_attn_fwd_mh_kernel. k and v are
// float32 or bf16 (the bf16 planes, read as bf16 and turned into float
// when they are read); q, m, l and acc are float32.
//
// Design. K9's row walk, over K13's own work list (PIECE_BLOCKS and
// PIECE_WORK["spmm_attention_mh"]), with a group of HG heads (1, 2, 4 or
// 8, a template parameter; ops/attention_mh.py picks it) per thread block
// (the head group the fastest of the grid's indices, so that every group's
// heaviest pieces start first):
// the bitmask, hind, the ballots and the queue are walked once per head
// group instead of once per head, and an item's ring slot holds its k row
// and v column chunk of every head of the group in the plane's type (a
// bf16 row at dk 8 is one 16-byte cp.async). A lane keeps, for each head,
// its row's online softmax in registers (m, l and kAcc columns of acc), and
// q too where HG x dk <= 64 (read through __ldg otherwise). A cut group's
// shares merge per head in attn_fwd_merge_kernel, in piece order. No
// atomics; no double sums: the order is fixed, so float32 repeats bit for
// bit. Bound: as K9's, per head.

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

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                const int32_t* __restrict__ hind,      // (B, K)
                const int32_t* __restrict__ tasks,     // (num_tasks, kTaskInts)
                const float* __restrict__ q,           // (nq, dk)
                const float* __restrict__ k,           // (nk, dk)
                const float* __restrict__ v,           // (nk, dv)
                float* __restrict__ out,               // (nq, dv)
                float* __restrict__ lse,               // (W * block_h,)
                float* __restrict__ ws_ml,             // (slots, tile rows, 2): m, l
                float* __restrict__ ws_acc,            // (slots, tile rows, dv)
                int words, int block_h, int block_w, int nq, int nk, int dk, int dv,
                float scale, float slope, int vec_k, int vec_v, int nb, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int* task = tasks + (int64_t)blockIdx.x * kTaskInts;
  const int w = task[kW], g = task[kG];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= min(kWarps, words - kWarps * g)) return;
  const int c0 = blockIdx.y * kAcc;
  const int cw = min(kAcc, dv - c0);
  const int ring_floats = nbuf * nb * slot_floats(dk, cw);
  float* ring = smem + warp * ring_floats;
  uint32_t* q_word = reinterpret_cast<uint32_t*>(smem + kWarps * ring_floats) + warp * 2 * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;  // the lane's row in the group's tile
  const bool in_window = r < group_rows(g, words, block_h);
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * g + r;
  const bool has_row = in_window && row < nq;
  const float* q_row = q + (has_row ? row : 0) * dk;
  const int kpad = (dk + 3) & ~3;
  float m = kNeg, l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  walk_word(bitmask, hind, task[kB0], task[kB1], words, kWarps * g + warp, block_w, nk, k, v,
            dk, dv, c0, cw, vec_k && vec_v, nb, nbuf, ring, q_word, q_src, has_row,
            [&](const float* s) {
              const float sc = act(dot4<true>(q_row, s, dk, vec_k), scale, slope);
              float p = 1.f;
              if (sc > m) {  // a new maximum: rescale what the row holds
                const float corr = expf(m - sc);
                l *= corr;
#pragma unroll
                for (int c = 0; c < kAcc; ++c) acc[c] *= corr;
                m = sc;
              } else {
                p = expf(sc - m);
              }
              l += p;
              axpy_staged<kAcc>(p, s + kpad, cw, acc);
            });

  const bool vec_out = vec_v && cw % 4 == 0;
  if (task[kSlot] < 0) {  // the group is this one piece: finish its rows
    if (has_row) store_row<kAcc>(out + row * dv + c0, acc, cw, 1.f / fmaxf(l, 1e-30f), vec_out);
    if (blockIdx.y == 0 && in_window) lse[row] = l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : kEmptyLse;
  } else if (in_window) {  // a share of a cut group, into the piece's slot
    const int64_t sh = (int64_t)(task[kSlot] + task[kRank]) * tile_rows(words) + r;
    if (blockIdx.y == 0) {
      ws_ml[2 * sh] = m;
      ws_ml[2 * sh + 1] = l;
    }
    store_row<kAcc>(ws_acc + sh * dv + c0, acc, cw, 1.f, vec_out);
  }
}

template <int kAcc>
int launch(const void* bitmask, const void* hind, const void* tasks, const void* merges,
           const void* q, const void* k, const void* v, void* out, void* lse, void* ws_ml,
           void* ws_acc, int num_tasks, int num_merges, int words, int block_h, int block_w,
           int nq, int nk, int dk, int dv, float scale, float slope, int vec_k, int vec_v,
           cudaStream_t s) {
  auto walk = attn_fwd_kernel<kAcc>;
  // the widest chunk's slots (every chunk but the last is kAcc columns)
  const int vw = min(kAcc, dv);
  int nb, nbuf;
  walk_geometry(dk, vw, &nb, &nbuf);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(dk, vw, nb, nbuf);
  cudaError_t err = allow_smem(walk, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk<<<dim3(num_tasks, (dv + kAcc - 1) / kAcc), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<float*>(ws_ml), static_cast<float*>(ws_acc), words,
      block_h, block_w, nq, nk, dk, dv, scale, slope, vec_k, vec_v, nb, nbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_merges == 0) return static_cast<int>(err);
  return launch_merge(merges, ws_ml, ws_acc, out, lse, num_merges, 1, words, block_h, nq, dv, 0,
                      s);
}

// --- K13: the same walk for a group of heads, on float32 or bf16 planes ----

// acc[c] = acc[c] * corr + coef * s[c] for c < cw (s staged, padded to 16
// bytes); corr is 1 unless the row's maximum moved
template <int kAcc, typename T>
__device__ __forceinline__ void axpy_rescaled(float coef, float corr, const T* s, int cw,
                                              float* acc) {
#pragma unroll
  for (int c = 0; c < kAcc; c += 4) {
    if (c < cw) {
      const float4 y = staged4(s + c);
      acc[c] = fmaf(coef, y.x, acc[c] * corr);
      acc[c + 1] = fmaf(coef, y.y, acc[c + 1] * corr);
      acc[c + 2] = fmaf(coef, y.z, acc[c + 2] * corr);
      acc[c + 3] = fmaf(coef, y.w, acc[c + 3] * corr);
    }
  }
}

// the walk's parameters, as K13's two kernels below take and pass them
#define VOLTRIX_MH_PARAMS                                                                     \
  const uint32_t *__restrict__ bitmask, /* (B, words, K) */                                  \
      const int32_t *__restrict__ hind,  /* (B, K) */                                        \
      const int32_t *__restrict__ tasks, /* (num_tasks, kTaskInts) */                        \
      const float *__restrict__ q,       /* (H, nq, dk), strides qs */                       \
      const T *__restrict__ k,           /* (H, nk, dk), strides ks */                       \
      const T *__restrict__ v,           /* (H, nk, dv), strides vs */                       \
      float *__restrict__ out,           /* (H, nq, dv) */                                   \
      float *__restrict__ lse,           /* (H, padded) */                                   \
      float *__restrict__ ws_ml,         /* (slots, H, tile rows, 2): m, l */                \
      float *__restrict__ ws_acc,        /* (slots, H, tile rows, dv) */                     \
      int heads, int words, int block_h, int block_w, int nq, int nk, int dk, int dv,       \
      int64_t padded, float scale, float slope, int vec_q, int vec_k, int vec_v, Strides qs, \
      Strides ks, Strides vs, int nb, int nbuf
#define VOLTRIX_MH_ARGS                                                                      \
  bitmask, hind, tasks, q, k, v, out, lse, ws_ml, ws_acc, heads, words, block_h, block_w, nq, \
      nk, dk, dv, padded, scale, slope, vec_q, vec_k, vec_v, qs, ks, vs, nb, nbuf

// K13's walk: K9's, with a group of HG heads (the last group may hold
// fewer) sharing the ballots, the queue and each item's ring slot, which
// holds the item's k row and v column chunk of every head of the group in
// the plane's type T. A lane keeps, for each head, its row's m, l and
// kAcc columns of acc, and q in registers when dk <= kQ (through __ldg
// otherwise), and folds an edge into all of them without a branch and with
// one exp: m' = max(m, s), l = l exp(m - m') + exp(s - m'), acc likewise,
// one of the two exps being 1. One thread block per (task and head group,
// column chunk).
template <typename T, int HG, int kAcc>
__device__ __forceinline__ void mh_fwd_walk(VOLTRIX_MH_PARAMS) {
  constexpr int kQ = 64 / HG;  // q columns a lane holds in registers, per head
  extern __shared__ __align__(16) float smem[];
  // the head group is the fastest index of the grid's x, so every group's
  // heaviest pieces start first (the task list runs heaviest first)
  const int ngroups = (heads + HG - 1) / HG;
  const int* task = tasks + (int64_t)(blockIdx.x / ngroups) * kTaskInts;
  const int w = task[kW], g = task[kG];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= min(kWarps, words - kWarps * g)) return;
  const int h0 = (blockIdx.x % ngroups) * HG;
  const int hg = min(HG, heads - h0);   // this block's heads
  const int hgl = min(HG, heads);       // the heads a slot has room for
  const int c0 = blockIdx.y * kAcc;
  const int cw = min(kAcc, dv - c0);
  const int vw = min(kAcc, dv);  // the widest chunk, which sizes the slots
  constexpr int esize = sizeof(T);
  const int kpad = pad16(dk, esize), vpad = pad16(vw, esize);
  const int sf = mh_slot_floats(dk, vw, hgl, esize);
  const int ring_floats = nbuf * nb * sf;
  float* ring = smem + warp * ring_floats;
  uint32_t* q_word = reinterpret_cast<uint32_t*>(smem + kWarps * ring_floats) + warp * 2 * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;  // the lane's row in the group's tile
  const bool in_window = r < group_rows(g, words, block_h);
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * g + r;
  const bool has_row = in_window && row < nq;
  const int64_t rr = has_row ? row : 0;
  const bool q_regs = dk <= kQ;
  float qr[HG][kQ];
  float m[HG], l[HG], acc[HG][kAcc];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const float* qh = q + (h0 + min(j, hg - 1)) * qs.head + rr * qs.row;
#pragma unroll
    for (int c = 0; c < kQ; ++c) qr[j][c] = q_regs && c < dk ? __ldg(qh + c) : 0.f;
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[j][c] = 0.f;
  }

  walk_items(
      bitmask, hind, task[kB0], task[kB1], words, kWarps * g + warp, block_w, nk, sf, nb, nbuf,
      ring, q_word, q_src, has_row,
      [&](float* slot, int64_t src) {
        T* st = reinterpret_cast<T*>(slot);
        for (int j = 0; j < hg; ++j) {
          stage_row(st + j * kpad, k + (h0 + j) * ks.head + src * ks.row, dk, vec_k);
          stage_row(st + hgl * kpad + j * vpad, v + (h0 + j) * vs.head + src * vs.row + c0, cw,
                    vec_v);
        }
      },
      [&](const float* s) {
        // every head's score first, then every head's fold: no branch, so
        // the heads' dependent chains interleave (a group's missing heads
        // repeat its last one and are never stored)
        const T* st = reinterpret_cast<const T*>(s);
        float sc[HG];
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* kst = st + jj * kpad;
          const float raw =
              q_regs ? dot_regs<kQ>(qr[j], kst, dk)
                     : dot_ldg(q + (h0 + jj) * qs.head + rr * qs.row, kst, dk, vec_q);
          sc[j] = act(raw, scale, slope);
        }
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          // one exp: exp(-|s - m|) is the rescale of what the row holds
          // when s is a new maximum (the edge's p is then 1), else the
          // edge's p (the rescale is then 1)
          const float d = sc[j] - m[j];
          const float e = __expf(-fabsf(d));
          const bool up = d > 0.f;
          const float corr = up ? e : 1.f, p = up ? 1.f : e;
          l[j] = fmaf(l[j], corr, p);
          m[j] = fmaxf(m[j], sc[j]);
          axpy_rescaled<kAcc>(p, corr, st + hgl * kpad + jj * vpad, cw, acc[j]);
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

// K13 over one head a block takes the registers ptxas picks; over a
// group, at least mh_min_blocks(HG) blocks an SM
template <typename T, int HG, int kAcc>
__global__ void __launch_bounds__(kThreads) attn_mh_fwd_kernel(VOLTRIX_MH_PARAMS) {
  mh_fwd_walk<T, HG, kAcc>(VOLTRIX_MH_ARGS);
}

template <typename T, int HG, int kAcc>
__global__ void __launch_bounds__(kThreads, mh_min_blocks(HG))
    attn_mh_fwd_group_kernel(VOLTRIX_MH_PARAMS) {
  mh_fwd_walk<T, HG, kAcc>(VOLTRIX_MH_ARGS);
}
#undef VOLTRIX_MH_PARAMS
#undef VOLTRIX_MH_ARGS

template <typename T, int HG, int kAcc>
int launch_mh(const void* bitmask, const void* hind, const void* tasks, const void* merges,
              const void* q, const void* k, const void* v, void* out, void* lse, void* ws_ml,
              void* ws_acc, int num_tasks, int num_merges, int heads, int words, int block_h,
              int block_w, int nq, int nk, int dk, int dv, int64_t padded, float scale,
              float slope, int vec_q, int vec_k, int vec_v, Strides qs, Strides ks,
              Strides vs, cudaStream_t s) {
  const auto walk = [] {
    if constexpr (HG == 1) {
      return attn_mh_fwd_kernel<T, HG, kAcc>;
    } else {
      return attn_mh_fwd_group_kernel<T, HG, kAcc>;
    }
  }();
  const int sf = mh_slot_floats(dk, min(kAcc, dv), min(HG, heads), sizeof(T));
  int nb, nbuf;
  walk_geometry_sf(sf, HG >= 4 ? kWideWalkSmem : kWalkSmem, &nb, &nbuf);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ring_smem_bytes(sf, nb, nbuf);
  cudaError_t err = allow_smem(walk, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk<<<dim3(num_tasks * ((heads + HG - 1) / HG), (dv + kAcc - 1) / kAcc), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<float*>(ws_ml), static_cast<float*>(ws_acc), heads,
      words, block_h, block_w, nq, nk, dk, dv, padded, scale, slope, vec_q, vec_k, vec_v, qs, ks,
      vs, nb, nbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_merges == 0) return static_cast<int>(err);
  return launch_merge(merges, ws_ml, ws_acc, out, lse, num_merges, heads, words, block_h, nq, dv,
                      padded, s);
}

template <typename T>
int dispatch_mh(int hg, int acc, const void* bitmask, const void* hind, const void* tasks,
                const void* merges, const void* q, const void* k, const void* v, void* out,
                void* lse, void* ws_ml, void* ws_acc, int num_tasks, int num_merges, int heads,
                int words, int block_h, int block_w, int nq, int nk, int dk, int dv,
                int64_t padded, float scale, float slope, int vec_q, int vec_k, int vec_v,
                Strides qs, Strides ks, Strides vs, cudaStream_t s) {
#define VOLTRIX_MH(HG, N)                                                                    \
  if (hg == HG && acc == N) {                                                                \
    return launch_mh<T, HG, N>(bitmask, hind, tasks, merges, q, k, v, out, lse, ws_ml,       \
                               ws_acc, num_tasks, num_merges, heads, words, block_h,         \
                               block_w, nq, nk, dk, dv, padded, scale, slope, vec_q, vec_k,  \
                               vec_v, qs, ks, vs, s);                                        \
  }
  // the (head group, column chunk) pairs whose registers fit a lane
  // (ops/attention_mh.py:MH_ACC_WIDTHS)
  VOLTRIX_MH(1, 8)
  VOLTRIX_MH(1, 16)
  VOLTRIX_MH(1, 32)
  VOLTRIX_MH(1, 40)
  VOLTRIX_MH(1, 64)
  VOLTRIX_MH(2, 8)
  VOLTRIX_MH(2, 16)
  VOLTRIX_MH(2, 40)
  VOLTRIX_MH(4, 8)
  VOLTRIX_MH(4, 16)
  VOLTRIX_MH(8, 8)
#undef VOLTRIX_MH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K9 on `stream` (the walk over `tasks` and, when a group is cut,
// the merge) and returns cudaGetLastError() as an int (0 on success;
// cudaErrorInvalidValue for a geometry it does not take). Every row of
// `out` and `lse` is written. The workspace holds `slots` shares of
// tile_rows(words) rows: ws_ml 2 floats a row, ws_acc dv. acc is the
// column chunk a lane keeps (8, 16, 32, 40 or 64). vec_k: dk % 4 == 0 with
// q and k 16-byte aligned; vec_v: dv % 4 == 0 with v and out aligned.
int voltrix_attn_fwd(const void* bitmask, const void* hind, const void* tasks,
                     const void* merges, const void* q, const void* k, const void* v, void* out,
                     void* lse, void* ws_ml, void* ws_acc, int num_tasks, int num_merges,
                     int words, int block_h, int block_w, int nq, int nk, int dk, int dv, int acc,
                     float scale, float slope, int vec_k, int vec_v, void* stream) {
  if (num_tasks <= 0 || num_merges < 0 || words <= 0 || words * 32 < block_h || block_h <= 0 ||
      block_w <= 0 || nq <= 0 || nk <= 0 || dk < 0 || dv <= 0 || (vec_k && dk % 4) ||
      (vec_v && dv % 4) || (dv + acc - 1) / acc > 65535 || (num_merges && !ws_ml)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLTRIX_FWD(N)                                                                       \
  case N:                                                                                    \
    return launch<N>(bitmask, hind, tasks, merges, q, k, v, out, lse, ws_ml, ws_acc,         \
                     num_tasks, num_merges, words, block_h, block_w, nq, nk, dk, dv, scale, \
                     slope, vec_k, vec_v, s);
  switch (acc) {
    VOLTRIX_FWD(8)
    VOLTRIX_FWD(16)
    VOLTRIX_FWD(32)
    VOLTRIX_FWD(40)
    VOLTRIX_FWD(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOLTRIX_FWD
}

// Launches K13 on `stream` (the walk over `tasks` for every head group
// and, when a group of rows is cut, the merge of each head's shares) and
// returns cudaGetLastError() as an int (0 on success;
// cudaErrorInvalidValue for a geometry it does not take). Every row of
// `out` (heads, nq, dv) and `lse` (heads, padded: the plan's padded
// rows) is written. The
// workspace holds `slots` shares of heads x tile_rows(words) rows: ws_ml 2
// floats a row, ws_acc dv. hg heads share a thread block's walk and acc
// columns of v a lane's registers: the pairs of dispatch_mh. k and v are
// bf16 when bf16 != 0, else float; q is float. Head h's row r of q
// starts at q + h * q_head + r * q_row (elements; a row's values are
// contiguous), and likewise for k and v, so the node-major projections of
// a model need no copy. vec_q: dk % 4 == 0 with q's rows 16-byte aligned;
// vec_k, vec_v: rows of k and of v a multiple of 16 bytes, 16-byte
// aligned.
int voltrix_attn_mh_fwd(const void* bitmask, const void* hind, const void* tasks,
                        const void* merges, const void* q, const void* k, const void* v,
                        void* out, void* lse, void* ws_ml, void* ws_acc, int num_tasks,
                        int num_merges, int heads, int hg, int words, int block_h, int block_w,
                        int nq, int nk, int dk, int dv, int padded, int acc, int bf16,
                        float scale, float slope, int vec_q, int vec_k, int vec_v,
                        long long q_head, long long q_row, long long k_head, long long k_row,
                        long long v_head, long long v_row, void* stream) {
  if (num_tasks <= 0 || num_merges < 0 || heads <= 0 || hg <= 0 ||
      (int64_t)num_tasks * ((heads + hg - 1) / hg) > INT32_MAX || words <= 0 ||
      words * 32 < block_h || block_h <= 0 || block_w <= 0 || nq <= 0 || nk <= 0 || dk < 0 ||
      dv <= 0 || padded < nq || acc <= 0 ||
      (dv + acc - 1) / acc > 65535 || (vec_q && dk % 4) || (num_merges && !ws_ml) ||
      q_head < 0 || q_row < 0 || k_head < 0 || k_row < 0 || v_head < 0 || v_row < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_head, q_row}, ks{k_head, k_row}, vs{v_head, v_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_mh<__nv_bfloat16>(hg, acc, bitmask, hind, tasks, merges, q, k, v, out,
                                           lse, ws_ml, ws_acc, num_tasks, num_merges, heads,
                                           words, block_h, block_w, nq, nk, dk, dv, padded,
                                           scale, slope, vec_q, vec_k, vec_v, qs, ks, vs, s)
              : dispatch_mh<float>(hg, acc, bitmask, hind, tasks, merges, q, k, v, out, lse,
                                   ws_ml, ws_acc, num_tasks, num_merges, heads, words, block_h,
                                   block_w, nq, nk, dk, dv, padded, scale, slope, vec_q, vec_k,
                                   vec_v, qs, ks, vs, s);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Kernel K14: the dQ half of the multi-head fused attention's backward,
// for sm_90a, over the plan of A. For head h, destination row r and its
// in-neighbours l:
//
//   raw = q[h, r] . k[h, l],  p = exp(leaky_relu(scale * raw) - lse[h, r])
//   ds  = p * (dO[h, r] . v[h, l] - D[h, r]) * (raw > 0 ? 1 : slope) * scale
//   dq[h, r] = sum_l ds * k[h, l]
//
// with lse from the forward (K13) and D = rowsum(dO o out). At one head
// with float32 planes it is K11 (ops/attention.py:attention_dq).
//
// Replaces voltrix_spmm_tpu/ops/attention_mh.py:_attn_bwd_dq_mh_kernel
// together with its [k || v] gather and the [q || dO] pair plane. The TPU
// forms the (block_h, U*K) score, p and dP tiles on the MXU per step and
// multiplies ds by the gathered [k || v] block, slicing the pollution of
// the v zone off on the host. Here q and dO (float32) and k and v (float32,
// or bf16 for the bf16 plane) are read through their head and row strides,
// k and v gathered by hind inside the kernel; lse and D come from their own
// float arrays.
//
// Design. K10's dq pass (attn_bwd.cu) with K13's head group (attn_fwd.cu):
// the row walk of attn_walk.cuh over K14's own work list
// (ops/block_spmm.py: PIECE_BLOCKS and PIECE_WORK["attention_mh_dq"]), a
// thread block per (task and group of HG heads, chunk of kAcc columns of
// dq), the head group the fastest of the grid's indices. A lane owns
// destination row r: for each head of its group it keeps lse[h, r], D[h, r]
// and kAcc dq columns in registers, and q[h, r] and dO[h, r] too where they
// fit (dk, dv <= kAcc and HG x kAcc <= 32; read through __ldg otherwise).
// Each staged item brings k[h, src] and v[h, src] of the group's heads in
// the plane's type; every lane takes its own edges in lane order, and for
// each head computes raw, p, dP and ds and adds ds * k[h, src] to its dq.
// A score is one chain of fmas in column order (bwd_dot_regs<kQ, 1>), as
// K14's first kernel took it, so a score within rounding of 0 takes the same
// slope of leaky_relu; p = __expf, as in K13. A group of two or more heads
// holds at least mh_min_blocks(HG) thread blocks an SM (registers capped),
// one head what ptxas picks. Cut groups: piece 0 writes dq's rows, pieces
// 1.. workspace tiles (one workspace per head) that spmm_walk.cuh's merge
// adds in piece order. Every row of dq is written, a row without edges
// with zeros. No atomics; every sum runs in a fixed order, so two launches
// give the same bits.
//
// Bound. Per edge and head 4 * dk + 2 * dv flops and an exp; the bytes are
// the plan, q, k, v, dO, lse, D and dq once each. The per-item gathers of k
// and v rows (L2 hits on the arxiv proxy) and a hub row's edges, one a
// step, separate the kernel from it.
//
// compute_dtype=bfloat16 (kBf; attention_mh.py:436-463, attention.py:465-488
// for K11): the same walk and merge, with JAX's rounding points. q, k, v and
// dO are rounded to bf16 where they are read (a bf16 plane's k and v are
// already); raw = q . k and dP = dO . v are one fma chain each in column
// order (each product exact); p = expf, not __expf, the function torch.exp
// runs on the card; ds = p (dP - D) act'(raw) scale, each product rounded on
// its own, and draw = bf16(ds) multiplies the rounded k. So the plain
// version (ops/_attn_core.py:_dq_plain) rounds the same draw, and only the
// order of dq's float32 sums differs. The same bound; the roundings, expf
// and the single chains add instructions an edge.

#include "attn_walk.cuh"

namespace {

using voltrix_attn::act;
using voltrix_attn::act_grad;
using namespace voltrix_attn_walk;
using voltrix_walk::kB0;
using voltrix_walk::kB1;
using voltrix_walk::kG;
using voltrix_walk::kRank;
using voltrix_walk::kSlot;
using voltrix_walk::kTaskInts;
using voltrix_walk::kW;
using voltrix_walk::tile_rows;

// the walk's parameters, as K14's two kernels below take and pass them
#define VOLTRIX_DQ_PARAMS                                                                     \
  const uint32_t *__restrict__ bitmask, /* (B, words, K) */                                  \
      const int32_t *__restrict__ hind,  /* (B, K) */                                        \
      const int32_t *__restrict__ tasks, /* (num_tasks, kTaskInts) */                        \
      const float *__restrict__ q,       /* (H, nq, dk), strides qs */                       \
      const T *__restrict__ k,           /* (H, nk, dk), strides ks */                       \
      const T *__restrict__ v,           /* (H, nk, dv), strides vs */                       \
      const float *__restrict__ g,       /* dO, (H, nq, dv), strides gs */                   \
      const float *__restrict__ lse,     /* (H, lse_stride) */                               \
      const float *__restrict__ drow,    /* D, (H, nq) */                                    \
      float *__restrict__ dq,            /* (H, nq, dk) */                                   \
      float *__restrict__ ws,            /* (H, slots, tile rows, dk) */                     \
      int heads, int words, int block_h, int block_w, int nq, int nk, int dk, int dv,       \
      int lse_stride, int slots, float scale, float slope, int vec_q, int vec_g, int vec_k, \
      int vec_v, Strides qs, Strides ks, Strides vs, Strides gs, int nb, int nbuf
#define VOLTRIX_DQ_ARGS                                                                      \
  bitmask, hind, tasks, q, k, v, g, lse, drow, dq, ws, heads, words, block_h, block_w, nq,   \
      nk, dk, dv, lse_stride, slots, scale, slope, vec_q, vec_g, vec_k, vec_v, qs, ks, vs, \
      gs, nb, nbuf

template <typename T, int HG, int kAcc, bool kBf>
__device__ __forceinline__ void dq_walk(VOLTRIX_DQ_PARAMS) {
  // q and dO values a lane keeps in registers per head where HG x kAcc <=
  // 32 and the rows fit (dk, dv <= kAcc); else the rows are read through
  // __ldg, and the register path is not compiled
  constexpr bool kRegs = HG * kAcc <= 32;
  constexpr int kQ = kRegs ? kAcc : 4;
  extern __shared__ __align__(16) float smem[];
  const int ngroups = (heads + HG - 1) / HG;
  const int* task = tasks + (int64_t)(blockIdx.x / ngroups) * kTaskInts;
  const int w = task[kW], grp = task[kG];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= min(kWarps, words - kWarps * grp)) return;
  const int h0 = (blockIdx.x % ngroups) * HG;
  const int hg = min(HG, heads - h0);  // this block's heads
  const int hgl = min(HG, heads);      // the heads a slot has room for
  const int c0 = blockIdx.y * kAcc;
  const int cw = min(kAcc, dk - c0);
  constexpr int esize = sizeof(T);
  const int kpad = pad16(dk, esize), vpad = pad16(dv, esize);
  const int sf = mh_slot_floats(dk, dv, hgl, esize);
  const int ring_floats = nbuf * nb * sf;
  float* ring = smem + warp * ring_floats;
  uint32_t* q_word = reinterpret_cast<uint32_t*>(smem + kWarps * ring_floats) + warp * 2 * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;  // the lane's row in the group's tile
  const bool in_window = r < group_rows(grp, words, block_h);
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * grp + r;
  const bool has_row = in_window && row < nq;
  const int64_t rr = has_row ? row : 0;
  const bool regs = kRegs && dk <= kQ && dv <= kQ;
  float qr[HG][kQ], gr[HG][kQ], lse_r[HG], d_r[HG], acc[HG][kAcc];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const int64_t h = h0 + min(j, hg - 1);
    const float* qh = q + h * qs.head + rr * qs.row;
    const float* gh = g + h * gs.head + rr * gs.row;
#pragma unroll
    for (int c = 0; c < kQ; ++c) {
      qr[j][c] = regs && c < dk ? __ldg(qh + c) : 0.f;
      gr[j][c] = regs && c < dv ? __ldg(gh + c) : 0.f;
      if constexpr (kBf) {
        qr[j][c] = bf16_round(qr[j][c]);
        gr[j][c] = bf16_round(gr[j][c]);
      }
    }
    lse_r[j] = has_row ? __ldg(lse + h * lse_stride + rr) : 0.f;
    d_r[j] = has_row ? __ldg(drow + h * nq + rr) : 0.f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[j][c] = 0.f;
  }

  walk_items(
      bitmask, hind, task[kB0], task[kB1], words, kWarps * grp + warp, block_w, nk, sf, nb, nbuf,
      ring, q_word, q_src, has_row,
      [&](float* slot, int64_t src) {
        T* st = reinterpret_cast<T*>(slot);
        for (int j = 0; j < hg; ++j) {
          stage_row(st + j * kpad, k + (h0 + j) * ks.head + src * ks.row, dk, vec_k);
          stage_row(st + hgl * kpad + j * vpad, v + (h0 + j) * vs.head + src * vs.row, dv, vec_v);
        }
      },
      [&](const float* s) {
        // every head's score first, then every head's ds and sum, so the
        // heads' dependent chains interleave (a group's missing heads
        // repeat its last one and are never stored)
        const T* st = reinterpret_cast<const T*>(s);
        float raw[HG];
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* kst = st + jj * kpad;
          const float* qh = q + (h0 + jj) * qs.head + rr * qs.row;
          if constexpr (kBf) {
            raw[j] = regs ? score_regs<kQ>(qr[j], kst, dk) : score_ldg(qh, kst, dk);
          } else {
            raw[j] = regs ? bwd_dot_regs<kQ, 1>(qr[j], kst, dk)
                          : bwd_dot_ldg<1>(qh, kst, dk, vec_q);
          }
        }
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* vst = st + hgl * kpad + jj * vpad;
          const float* gh = g + (h0 + jj) * gs.head + rr * gs.row;
          if constexpr (kBf) {
            const float p = expf(act_rn(raw[j], scale, slope) - lse_r[j]);
            const float dp = regs ? score_regs<kQ>(gr[j], vst, dv) : score_ldg(gh, vst, dv);
            const float draw = draw_bf16(p, dp, d_r[j], raw[j], scale, slope);
            axpy_bf16<kAcc>(draw, st + jj * kpad + c0, cw, acc[j]);
          } else {
            const float p = __expf(act(raw[j], scale, slope) - lse_r[j]);
            const float dp =
                regs ? bwd_dot_regs<kQ, 4>(gr[j], vst, dv) : bwd_dot_ldg<4>(gh, vst, dv, vec_g);
            const float ds = p * (dp - d_r[j]) * act_grad(raw[j], slope) * scale;
            axpy_typed<kAcc>(ds, st + jj * kpad + c0, cw, acc[j]);
          }
        }
      });

  const bool vec_out = dk % 4 == 0 && cw % 4 == 0;
  const int rank = task[kRank];
  const int tile = tile_rows(words);
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    if (j < hg) {
      const int64_t h = h0 + j;
      if (rank == 0) {  // piece 0 (or the group's only piece): dq's rows
        if (has_row) store_row<kAcc>(dq + (h * nq + row) * dk + c0, acc[j], cw, 1.f, vec_out);
      } else if (in_window) {  // piece rank of a cut group: its workspace tile
        const int64_t t = (h * slots + task[kSlot] + rank - 1) * tile + r;
        store_row<kAcc>(ws + t * dk + c0, acc[j], cw, 1.f, vec_out);
      }
    }
  }
}

// K14 over one head a block takes the registers ptxas picks; over a
// group, at least mh_min_blocks(HG) blocks an SM
template <typename T, int HG, int kAcc, bool kBf>
__global__ void __launch_bounds__(kThreads) attn_mh_dq_kernel(VOLTRIX_DQ_PARAMS) {
  dq_walk<T, HG, kAcc, kBf>(VOLTRIX_DQ_ARGS);
}

template <typename T, int HG, int kAcc, bool kBf>
__global__ void __launch_bounds__(kThreads, mh_min_blocks(HG))
    attn_mh_dq_group_kernel(VOLTRIX_DQ_PARAMS) {
  dq_walk<T, HG, kAcc, kBf>(VOLTRIX_DQ_ARGS);
}
#undef VOLTRIX_DQ_PARAMS
#undef VOLTRIX_DQ_ARGS

template <typename T, int HG, int kAcc, bool kBf>
int launch(const void* bitmask, const void* hind, const void* tasks, const void* merges,
           const void* q, const void* k, const void* v, const void* g, const void* lse,
           const void* drow, void* dq, void* ws, int num_tasks, int num_merges, int slots,
           int heads, int words, int block_h, int block_w, int nq, int nk, int dk, int dv,
           int lse_stride, float scale, float slope, int vec_q, int vec_g, int vec_k, int vec_v,
           Strides qs, Strides ks, Strides vs, Strides gs, cudaStream_t s) {
  const auto walk = [] {
    if constexpr (HG == 1) {
      return attn_mh_dq_kernel<T, HG, kAcc, kBf>;
    } else {
      return attn_mh_dq_group_kernel<T, HG, kAcc, kBf>;
    }
  }();
  const int sf = mh_slot_floats(dk, dv, min(HG, heads), sizeof(T));
  int nb, nbuf;
  walk_geometry_sf(sf, kWalkSmem, &nb, &nbuf);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ring_smem_bytes(sf, nb, nbuf);
  cudaError_t err = allow_smem(walk, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk<<<dim3(num_tasks * ((heads + HG - 1) / HG), (dk + kAcc - 1) / kAcc), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(drow), static_cast<float*>(dq),
      static_cast<float*>(ws), heads, words, block_h, block_w, nq, nk, dk, dv, lse_stride, slots,
      scale, slope, vec_q, vec_g, vec_k, vec_v, qs, ks, vs, gs, nb, nbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(voltrix_walk::launch_merge(
      merges, ws, dq, num_merges, words, block_h, nq, dk, dk % 4 == 0, s, voltrix_walk::kWarps,
      heads, (int64_t)nq * dk, (int64_t)slots * tile_rows(words) * dk));
}

template <typename T, bool kBf>
int dispatch(int hg, int acc, const void* bitmask, const void* hind, const void* tasks,
             const void* merges, const void* q, const void* k, const void* v, const void* g,
             const void* lse, const void* drow, void* dq, void* ws, int num_tasks,
             int num_merges, int slots, int heads, int words, int block_h, int block_w, int nq,
             int nk, int dk, int dv, int lse_stride, float scale, float slope, int vec_q,
             int vec_g, int vec_k, int vec_v, Strides qs, Strides ks, Strides vs, Strides gs,
             cudaStream_t s) {
#define VOLTRIX_DQ(HG, N)                                                                      \
  if (hg == HG && acc == N) {                                                                  \
    return launch<T, HG, N, kBf>(bitmask, hind, tasks, merges, q, k, v, g, lse, drow, dq, ws,  \
                            num_tasks, num_merges, slots, heads, words, block_h, block_w, nq, \
                            nk, dk, dv, lse_stride, scale, slope, vec_q, vec_g, vec_k, vec_v, \
                            qs, ks, vs, gs, s);                                                \
  }
  // the (head group, column chunk) pairs of ops/_attn_core.py:BWD_ACC_WIDTHS
  // (the same in attn_mh_dkv.cu)
  VOLTRIX_DQ(1, 8)
  VOLTRIX_DQ(1, 16)
  VOLTRIX_DQ(1, 32)
  VOLTRIX_DQ(1, 40)
  VOLTRIX_DQ(1, 64)
  VOLTRIX_DQ(2, 8)
  VOLTRIX_DQ(2, 16)
  VOLTRIX_DQ(4, 8)
#undef VOLTRIX_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K14 on `stream` (the walk over `tasks` for every head group
// and, when a group of rows is cut, the merge of each head's pieces) and
// returns cudaGetLastError() as an int (0 on success;
// cudaErrorInvalidValue for a geometry it does not take). Every row of dq
// (heads, nq, dk) is written. The workspace `ws` holds, for each head,
// `slots` tiles of tile_rows(words) x dk floats. hg heads share a thread
// block's walk and acc columns of dq a lane's registers: the pairs of
// dispatch. k and v are bf16 when bf16 != 0, else float; q, dO, lse and D
// are float. compute != 0: compute_dtype=bfloat16 (the kBf variant). Head
// h's row r of q starts at q + h * q_head + r * q_row (elements; a row's
// values contiguous), and likewise for k, v and dO.
// vec_q, vec_g: rows of q and dO read four floats at a time (d % 4 == 0,
// 16-byte aligned rows); vec_k, vec_v: rows of k and v a multiple of 16
// bytes, 16-byte aligned (staged by 16-byte copies).
int voltrix_attn_mh_dq(const void* bitmask, const void* hind, const void* tasks,
                       const void* merges, const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* drow, void* dq, void* ws,
                       int num_tasks, int num_merges, int slots, int heads, int hg, int words,
                       int block_h, int block_w, int nq, int nk, int dk, int dv, int lse_stride,
                       int acc, int bf16, int compute, float scale, float slope, int vec_q,
                       int vec_g, int vec_k, int vec_v, long long q_head, long long q_row,
                       long long k_head, long long k_row, long long v_head, long long v_row,
                       long long g_head, long long g_row, void* stream) {
  if (num_tasks <= 0 || num_merges < 0 || slots < 0 || heads <= 0 || hg <= 0 ||
      (int64_t)num_tasks * ((heads + hg - 1) / hg) > INT32_MAX || heads > 65535 || words <= 0 ||
      words * 32 < block_h || block_h <= 0 || block_w <= 0 || nq <= 0 || nk <= 0 || dk <= 0 ||
      dv < 0 || lse_stride < nq || acc <= 0 || (dk + acc - 1) / acc > 65535 ||
      (num_merges && !ws) || (vec_q && dk % 4) || (vec_g && dv % 4) || q_head < 0 ||
      q_row < 0 || k_head < 0 || k_row < 0 || v_head < 0 || v_row < 0 || g_head < 0 ||
      g_row < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_head, q_row}, ks{k_head, k_row}, vs{v_head, v_row}, gs{g_head, g_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto f) {
    return f(hg, acc, bitmask, hind, tasks, merges, q, k, v, g, lse, drow, dq, ws, num_tasks,
             num_merges, slots, heads, words, block_h, block_w, nq, nk, dk, dv, lse_stride, scale,
             slope, vec_q, vec_g, vec_k, vec_v, qs, ks, vs, gs, s);
  };
  if (compute) {
    return bf16 ? run(dispatch<__nv_bfloat16, true>) : run(dispatch<float, true>);
  }
  return bf16 ? run(dispatch<__nv_bfloat16, false>) : run(dispatch<float, false>);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Kernel K15: the dK/dV half of the multi-head fused attention's backward,
// for sm_90a, over the plan of A^T. Its windows own source rows l (rows of
// k and v); its lanes are the destination rows r that attend to them. For
// head h and each edge (r <- l):
//
//   raw = k[h, l] . q[h, r],  p = exp(leaky_relu(scale * raw) - lse[h, r])
//   ds  = p * (v[h, l] . dO[h, r] - D[h, r]) * (raw > 0 ? 1 : slope) * scale
//   dk[h, l] = sum_r ds * q[h, r],   dv[h, l] = sum_r p * dO[h, r]
//
// At one head with float32 planes it is K12 (ops/attention.py:
// attention_dkv).
//
// Replaces voltrix_spmm_tpu/ops/attention_mh.py:_attn_bwd_dkv_mh_kernel
// together with its gathered [q || dO || stats] plane. The TPU packs lse and
// D into the gathered plane (as hi/lo bf16 pairs when the plane is bf16) and
// selects each head's lane with a masked reduce. Here k, v (the window's own
// rows) and q, dO (gathered by hind) are read through their head and row
// strides, float or bf16 (the bf16 plane rounds all four, as the TPU's kvw
// and qdo planes do); lse and D are read from their own float arrays.
//
// Design. The row walk of attn_walk.cuh over the transpose plan, on K15's
// own work list (ops/block_spmm.py: PIECE_BLOCKS and
// PIECE_WORK["attention_mh_dkv"]), a thread block per (task and group of HG
// heads, chunk of kAcc columns of dk and of dv), the head group the fastest
// of the grid's indices. A lane owns source row l: for each head of its
// group it keeps kAcc columns of dk and of dv in registers, and k[h, l] and
// v[h, l] too where they fit (dk, dv <= kAcc and HG x kAcc <= 32; read
// through __ldg otherwise). Each staged item brings, for the group's heads,
// q[h, dst] and dO[h, dst] in the plane's type and lse[h, dst] and D[h,
// dst] as float32; every lane takes its own edges in lane order and, for
// each head, computes raw and p once, adds p * dO to its dv and ds * q to
// its dk; raw is one chain of fmas in column order and p = __expf, as in
// K14. A chunk of columns past dk (dv wider) skips dP. The registers are
// left to ptxas: capped at four thread blocks an SM, a group of two heads
// spilled and timed slower at path G's layer 1. Cut groups: piece
// 0 writes dk's and dv's rows, pieces 1.. workspace tiles (one each for dk
// and dv per head) that spmm_walk.cuh's merge adds in piece order. Every
// row of dk and dv is written. No slots a lane, no scatter, no atomics:
// every sum runs in a fixed order, so two launches give the same bits.
//
// Bound. Per edge and head 4 * (dk + dv) flops and an exp; the bytes are
// the transpose plan, q, k, v, dO, lse, D, dk and dv once each. The
// per-item gathers of q and dO rows and of lse and D, and a hub source's
// edges, one a step, separate the kernel from it.
//
// compute_dtype=bfloat16 (kBf; attention_mh.py:529-570, attention.py:535-569
// for K12): the same walk and merges, with JAX's rounding points. k, v, q
// and dO are rounded to bf16 where they are read; raw = k . q and dP = v .
// dO are one fma chain each in column order (each product exact); p =
// expf, not __expf; dv sums bf16(p) dO and dk sums draw q, draw = bf16(p
// (dP - D) act'(raw) scale) with each product rounded on its own. On bf16
// planes the wrapper passes lse and D as JAX's K15 reads them there, bf16
// hi + lo (ops/_attn_core.py:_dkv_stats). The plain version
// (ops/_attn_core.py:_dkv_plain) rounds the same p and draw. The same
// bound; the roundings, expf and the single chains add instructions an edge.

#include "attn_walk.cuh"

namespace {

using voltrix_attn::act;
using voltrix_attn::act_grad;
using voltrix_attn::to_f;
using namespace voltrix_attn_walk;
using voltrix_walk::kB0;
using voltrix_walk::kB1;
using voltrix_walk::kG;
using voltrix_walk::kRank;
using voltrix_walk::kSlot;
using voltrix_walk::kTaskInts;
using voltrix_walk::kW;
using voltrix_walk::tile_rows;

template <typename T, int HG, int kAcc, bool kBf>
__global__ void __launch_bounds__(kThreads)
attn_mh_dkv_kernel(const uint32_t* __restrict__ bitmask,  // plan_t (B, words, K)
                   const int32_t* __restrict__ hind,      // (B, K): destination rows
                   const int32_t* __restrict__ tasks,     // (num_tasks, kTaskInts)
                   const T* __restrict__ k,               // (H, nk, dk), strides ks
                   const T* __restrict__ v,               // (H, nk, dv), strides vs
                   const T* __restrict__ q,               // (H, nq, dk), strides qs
                   const T* __restrict__ g,               // dO, (H, nq, dv), strides gs
                   const float* __restrict__ lse,         // (H, lse_stride)
                   const float* __restrict__ drow,        // D, (H, nq)
                   float* __restrict__ dk_out,            // (H, nk, dk)
                   float* __restrict__ dv_out,            // (H, nk, dv)
                   float* __restrict__ ws_k,              // (H, slots, tile rows, dk)
                   float* __restrict__ ws_v,              // (H, slots, tile rows, dv)
                   int heads, int words, int block_h, int block_w, int nk, int nq, int dk, int dv,
                   int lse_stride, int slots, float scale, float slope, int vec_k, int vec_v,
                   int vec_q, int vec_g, Strides ks, Strides vs, Strides qs, Strides gs, int nb,
                   int nbuf) {
  // k and v values a lane keeps in registers per head where HG x kAcc <=
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
  const int cwk = max(0, min(kAcc, dk - c0)), cwv = max(0, min(kAcc, dv - c0));
  constexpr int esize = sizeof(T);
  const int kpad = pad16(dk, esize), vpad = pad16(dv, esize);
  // a slot: q rows of the group's heads, their dO rows, then lse and D of each
  const int stats = hgl * (kpad + vpad) * esize / 4;  // floats before lse
  const int sf = mh_slot_floats(dk, dv, hgl, esize, 2 * hgl);
  const int ring_floats = nbuf * nb * sf;
  float* ring = smem + warp * ring_floats;
  uint32_t* q_word = reinterpret_cast<uint32_t*>(smem + kWarps * ring_floats) + warp * 2 * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;  // the lane's row in the group's tile
  const bool in_window = r < group_rows(grp, words, block_h);
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * grp + r;
  const bool has_row = in_window && row < nk;
  const int64_t rr = has_row ? row : 0;
  const bool regs = kRegs && dk <= kQ && dv <= kQ;
  float kr[HG][kQ], vr[HG][kQ], acc_k[HG][kAcc], acc_v[HG][kAcc];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const int64_t h = h0 + min(j, hg - 1);
    const T* kh = k + h * ks.head + rr * ks.row;
    const T* vh = v + h * vs.head + rr * vs.row;
#pragma unroll
    for (int c = 0; c < kQ; ++c) {
      kr[j][c] = regs && c < dk ? to_f(__ldg(kh + c)) : 0.f;
      vr[j][c] = regs && c < dv ? to_f(__ldg(vh + c)) : 0.f;
      if constexpr (kBf) {
        kr[j][c] = bf16_round(kr[j][c]);
        vr[j][c] = bf16_round(vr[j][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;
  }

  walk_items(
      bitmask, hind, task[kB0], task[kB1], words, kWarps * grp + warp, block_w, nq, sf, nb, nbuf,
      ring, q_word, q_src, has_row,
      [&](float* slot, int64_t dst) {
        T* st = reinterpret_cast<T*>(slot);
        for (int j = 0; j < hg; ++j) {
          const int64_t h = h0 + j;
          stage_row(st + j * kpad, q + h * qs.head + dst * qs.row, dk, vec_q);
          stage_row(st + hgl * kpad + j * vpad, g + h * gs.head + dst * gs.row, dv, vec_g);
          voltrix_walk::cp_async4(slot + stats + j, lse + h * lse_stride + dst);
          voltrix_walk::cp_async4(slot + stats + hgl + j, drow + h * nq + dst);
        }
      },
      [&](const float* s) {
        // every head's score first, then every head's sums, so the heads'
        // dependent chains interleave (a group's missing heads repeat its
        // last one and are never stored)
        const T* st = reinterpret_cast<const T*>(s);
        float raw[HG];
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* qst = st + jj * kpad;
          const T* kh = k + (h0 + jj) * ks.head + rr * ks.row;
          if constexpr (kBf) {
            raw[j] = regs ? score_regs<kQ>(kr[j], qst, dk) : score_ldg(kh, qst, dk);
          } else {
            raw[j] = regs ? bwd_dot_regs<kQ, 1>(kr[j], qst, dk)
                          : bwd_dot_ldg<1>(kh, qst, dk, vec_k);
          }
        }
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const int jj = min(j, hg - 1);
          const T* gst = st + hgl * kpad + jj * vpad;
          const T* vh = v + (h0 + jj) * vs.head + rr * vs.row;
          if constexpr (kBf) {
            const float p = expf(act_rn(raw[j], scale, slope) - s[stats + jj]);
            axpy_bf16<kAcc>(bf16_round(p), gst + c0, cwv, acc_v[j]);
            if (cwk > 0) {
              const float dp = regs ? score_regs<kQ>(vr[j], gst, dv) : score_ldg(vh, gst, dv);
              const float draw = draw_bf16(p, dp, s[stats + hgl + jj], raw[j], scale, slope);
              axpy_bf16<kAcc>(draw, st + jj * kpad + c0, cwk, acc_k[j]);
            }
          } else {
            const float p = __expf(act(raw[j], scale, slope) - s[stats + jj]);
            axpy_typed<kAcc>(p, gst + c0, cwv, acc_v[j]);
            if (cwk > 0) {
              const float dp =
                  regs ? bwd_dot_regs<kQ, 4>(vr[j], gst, dv) : bwd_dot_ldg<4>(vh, gst, dv, vec_v);
              const float ds = p * (dp - s[stats + hgl + jj]) * act_grad(raw[j], slope) * scale;
              axpy_typed<kAcc>(ds, st + jj * kpad + c0, cwk, acc_k[j]);
            }
          }
        }
      });

  const bool vk = dk % 4 == 0 && cwk % 4 == 0, vv = dv % 4 == 0 && cwv % 4 == 0;
  const int rank = task[kRank];
  const int tile = tile_rows(words);
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    if (j < hg) {
      const int64_t h = h0 + j;
      float *ok = nullptr, *ov = nullptr;
      if (rank == 0 && has_row) {  // piece 0 (or the group's only piece): the rows
        ok = dk_out + (h * nk + row) * dk + c0;
        ov = dv_out + (h * nk + row) * dv + c0;
      } else if (rank > 0 && in_window) {  // piece rank of a cut group: its tiles
        const int64_t t = (h * slots + task[kSlot] + rank - 1) * tile + r;
        ok = ws_k + t * dk + c0;
        ov = ws_v + t * dv + c0;
      }
      if (ok != nullptr) {
        if (cwk > 0) store_row<kAcc>(ok, acc_k[j], cwk, 1.f, vk);
        if (cwv > 0) store_row<kAcc>(ov, acc_v[j], cwv, 1.f, vv);
      }
    }
  }
}

template <typename T, int HG, int kAcc, bool kBf>
int launch(const void* bitmask, const void* hind, const void* tasks, const void* merges,
           const void* k, const void* v, const void* q, const void* g, const void* lse,
           const void* drow, void* dk_out, void* dv_out, void* ws_k, void* ws_v, int num_tasks,
           int num_merges, int slots, int heads, int words, int block_h, int block_w, int nk,
           int nq, int dk, int dv, int lse_stride, float scale, float slope, int vec_k,
           int vec_v, int vec_q, int vec_g, Strides ks, Strides vs, Strides qs, Strides gs,
           cudaStream_t s) {
  auto walk = attn_mh_dkv_kernel<T, HG, kAcc, kBf>;
  const int hgl = min(HG, heads);
  const int sf = mh_slot_floats(dk, dv, hgl, sizeof(T), 2 * hgl);
  int nb, nbuf;
  walk_geometry_sf(sf, kWalkSmem, &nb, &nbuf);
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ring_smem_bytes(sf, nb, nbuf);
  cudaError_t err = allow_smem(walk, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk<<<dim3(num_tasks * ((heads + HG - 1) / HG), (max(dk, dv) + kAcc - 1) / kAcc), kThreads,
         smem, s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(tasks), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<float*>(dk_out), static_cast<float*>(dv_out),
      static_cast<float*>(ws_k), static_cast<float*>(ws_v), heads, words, block_h, block_w, nk,
      nq, dk, dv, lse_stride, slots, scale, slope, vec_k, vec_v, vec_q, vec_g, ks, vs, qs, gs, nb,
      nbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the cut groups of dk, then of dv
  auto merge = [&](void* ws, void* out, int d) {
    return voltrix_walk::launch_merge(merges, ws, out, num_merges, words, block_h, nk, d,
                                      d % 4 == 0, s, voltrix_walk::kWarps, heads,
                                      (int64_t)nk * d, (int64_t)slots * tile_rows(words) * d);
  };
  err = merge(ws_k, dk_out, dk);
  if (err == cudaSuccess) err = merge(ws_v, dv_out, dv);
  return static_cast<int>(err);
}

template <typename T, bool kBf>
int dispatch(int hg, int acc, const void* bitmask, const void* hind, const void* tasks,
             const void* merges, const void* k, const void* v, const void* q, const void* g,
             const void* lse, const void* drow, void* dk_out, void* dv_out, void* ws_k,
             void* ws_v, int num_tasks, int num_merges, int slots, int heads, int words,
             int block_h, int block_w, int nk, int nq, int dk, int dv, int lse_stride,
             float scale, float slope, int vec_k, int vec_v, int vec_q, int vec_g, Strides ks,
             Strides vs, Strides qs, Strides gs, cudaStream_t s) {
#define VOLTRIX_DKV(HG, N)                                                                     \
  if (hg == HG && acc == N) {                                                                  \
    return launch<T, HG, N, kBf>(bitmask, hind, tasks, merges, k, v, q, g, lse, drow, dk_out,  \
                            dv_out, ws_k, ws_v, num_tasks, num_merges, slots, heads, words,    \
                            block_h, block_w, nk, nq, dk, dv, lse_stride, scale, slope, vec_k, \
                            vec_v, vec_q, vec_g, ks, vs, qs, gs, s);                           \
  }
  // the (head group, column chunk) pairs of ops/_attn_core.py:BWD_ACC_WIDTHS
  // (the same in attn_mh_dq.cu)
  VOLTRIX_DKV(1, 8)
  VOLTRIX_DKV(1, 16)
  VOLTRIX_DKV(1, 32)
  VOLTRIX_DKV(1, 40)
  VOLTRIX_DKV(1, 64)
  VOLTRIX_DKV(2, 8)
  VOLTRIX_DKV(2, 16)
  VOLTRIX_DKV(4, 8)
#undef VOLTRIX_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches K15 on `stream` (the walk over the transpose plan's `tasks` for
// every head group and, when a group of rows is cut, the merges of each
// head's pieces of dk and of dv) and returns cudaGetLastError() as an int
// (0 on success; cudaErrorInvalidValue for a geometry it does not take).
// Every row of dk_out (heads, nk, dk) and dv_out (heads, nk, dv) is
// written. The workspaces hold, for each head, `slots` tiles of
// tile_rows(words) rows, dk floats a row (ws_k) and dv (ws_v). hg heads
// share a thread block's walk and acc columns of dk and of dv a lane's
// registers: the pairs of dispatch. k, v, q and dO are bf16 when bf16 !=
// 0, else float; lse and D are float. compute != 0: compute_dtype=bfloat16
// (the kBf variant). Head h's row r of k starts at k + h * k_head + r *
// k_row (elements; a row's values contiguous), and likewise for v, q and
// dO. vec_k, vec_v: rows of k and v read four values at a time (d % 4 ==
// 0, rows aligned to four values); vec_q, vec_g: rows
// of q and dO a multiple of 16 bytes, 16-byte aligned (staged by 16-byte
// copies).
int voltrix_attn_mh_dkv(const void* bitmask, const void* hind, const void* tasks,
                        const void* merges, const void* k, const void* v, const void* q,
                        const void* g, const void* lse, const void* drow, void* dk_out,
                        void* dv_out, void* ws_k, void* ws_v, int num_tasks, int num_merges,
                        int slots, int heads, int hg, int words, int block_h, int block_w, int nk,
                        int nq, int dk, int dv, int lse_stride, int acc, int bf16, int compute,
                        float scale, float slope, int vec_k, int vec_v, int vec_q, int vec_g,
                        long long k_head, long long k_row, long long v_head, long long v_row,
                        long long q_head, long long q_row, long long g_head, long long g_row,
                        void* stream) {
  if (num_tasks <= 0 || num_merges < 0 || slots < 0 || heads <= 0 || hg <= 0 ||
      (int64_t)num_tasks * ((heads + hg - 1) / hg) > INT32_MAX || heads > 65535 || words <= 0 ||
      words * 32 < block_h || block_h <= 0 || block_w <= 0 || nk <= 0 || nq <= 0 || dk < 0 ||
      dv < 0 || dk + dv <= 0 || lse_stride < nq || acc <= 0 ||
      (max(dk, dv) + acc - 1) / acc > 65535 || (num_merges && (!ws_k || !ws_v)) ||
      (vec_k && dk % 4) || (vec_v && dv % 4) || k_head < 0 || k_row < 0 || v_head < 0 ||
      v_row < 0 || q_head < 0 || q_row < 0 || g_head < 0 || g_row < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides ks{k_head, k_row}, vs{v_head, v_row}, qs{q_head, q_row}, gs{g_head, g_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto f) {
    return f(hg, acc, bitmask, hind, tasks, merges, k, v, q, g, lse, drow, dk_out, dv_out, ws_k,
             ws_v, num_tasks, num_merges, slots, heads, words, block_h, block_w, nk, nq, dk, dv,
             lse_stride, scale, slope, vec_k, vec_v, vec_q, vec_g, ks, vs, qs, gs, s);
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

// Kernel K10: the self-contained backward of the single-head fused
// attention, for sm_90a, over the plan of A alone. For destination row r
// and its in-neighbours l (lane (b, j) of the plan, hind[b, j] = l):
//
//   raw = q[r] . k[l],  p = exp(leaky_relu(scale * raw) - lse[r])
//   ds  = p * (dO[r] . v[l] - D[r]) * (raw > 0 ? 1 : slope) * scale
//   dq[r] = sum_l ds * k[l]                     (over the row's edges)
//   dk_lane[b, j] = sum_r ds * q[r],  dv_lane[b, j] = sum_r p * dO[r]
//                                               (over the lane's bits)
//
// with lse from the forward (K9) and D = rowsum(dO o out); then, as the
// JAX package's _attn_bwd sums the lane planes into source rows with
// segment_sum over hind, dk[s] = sum of dk_lane over the lanes whose hind
// is s (dv likewise), lanes with hind outside [0, nk) dropped.
//
// Replaces voltrix_spmm_tpu/ops/attention.py:_attn_bwd_kernel together with
// its [k || v] gather. The TPU forms the (block_h, U*K) p and ds tiles on
// the MXU per grid step, accumulates dq into the window's revisited output
// block and writes the (U*K, d) lane planes as two transposed products.
// Here q, dO (the window's rows) and k, v (gathered by hind) are read as
// float32 (n, d) matrices inside the kernels.
//
// Design: three passes, no float atomics, every sum in a fixed order.
// - dq: the row walk of attn_walk.cuh on K1's work list (a lane per row,
//   its dq columns in registers, each staged item bringing k[src] and
//   v[src]); piece 0 of a group writes dq's rows, pieces 1.. workspace
//   tiles that spmm_walk.cuh's merge adds in piece order.
// - the lanes: a thread per lane that holds a bit (in lane order, the
//   wrapper's list), walking its bits in row order with q, dO of the
//   window's rows and k[src], v[src] its own; it writes the lane's sums to
//   the lane's slot in the source order (ops/attention.py:
//   lane_source_order: the lanes grouped by hind, in lane order within a
//   source), one chunk of kAcc columns of dk and of dv per thread, so the
//   two dots of an edge are taken once a chunk. Only lanes with bits are
//   written.
// - the sums (when asked): a warp per source row adds its slots in a fixed
//   order (sum_slots_kernel).
// So dq, dk and dv are the same in every run.
//
// Bound. Per edge 6 * dk + 4 * dv flops and an exp; the bytes are the
// plan, q, k, v, dO, lse, D, dq, dk and dv once each. The gathers of k
// and v rows (one per queued lane in the dq walk, one per lane in the
// lane pass), a hub row's edges taken one a step in the dq walk, and the
// slots (lanes with bits x (dk + dv) floats, written and read once)
// separate the kernels from it.

#include "attn_mh_common.cuh"
#include "attn_walk.cuh"

namespace {

using voltrix_attn::act;
using voltrix_attn::act_grad;
using voltrix_attn::load4;
using voltrix_attn::window_rows;
using namespace voltrix_attn_walk;
using voltrix_walk::kB0;
using voltrix_walk::kB1;
using voltrix_walk::kG;
using voltrix_walk::kRank;
using voltrix_walk::kSlot;
using voltrix_walk::kTaskInts;
using voltrix_walk::kW;
using voltrix_walk::tile_rows;

constexpr int kSumCols = 128;  // columns of a sum thread block's warp: four a lane
constexpr int kSumBatch = 8;   // slots a sum lane loads at once

// dq through the row walk; piece 0 of a group into dq, pieces 1.. into
// their workspace tiles.
template <int kAcc>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                   const int32_t* __restrict__ hind,      // (B, K)
                   const int32_t* __restrict__ tasks,     // (num_tasks, kTaskInts)
                   const float* __restrict__ q,           // (nq, dk)
                   const float* __restrict__ k,           // (nk, dk)
                   const float* __restrict__ v,           // (nk, dv)
                   const float* __restrict__ g,           // dO, (nq, dv)
                   const float* __restrict__ lse,         // (>= nq,)
                   const float* __restrict__ drow,        // D, (nq,)
                   float* __restrict__ dq,                // (nq, dk)
                   float* __restrict__ ws,                // (slots, tile rows, dk)
                   int words, int block_h, int block_w, int nq, int nk, int dk, int dv,
                   float scale, float slope, int vec_k, int vec_v, int nb, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int* task = tasks + (int64_t)blockIdx.x * kTaskInts;
  const int w = task[kW], gr = task[kG];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= min(kWarps, words - kWarps * gr)) return;
  const int c0 = blockIdx.y * kAcc;
  const int cw = min(kAcc, dk - c0);
  const int sf = slot_floats(dk, dv);
  float* ring = smem + warp * nbuf * nb * sf;
  uint32_t* q_word = reinterpret_cast<uint32_t*>(smem + kWarps * nbuf * nb * sf) + warp * 2 * kQueue;
  int32_t* q_src = reinterpret_cast<int32_t*>(q_word + kQueue);

  const int r = 32 * warp + lane;
  const bool in_window = r < group_rows(gr, words, block_h);
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * gr + r;
  const bool has_row = in_window && row < nq;
  const int64_t rr = has_row ? row : 0;
  const float lse_r = has_row ? __ldg(lse + rr) : 0.f;
  const float d_r = has_row ? __ldg(drow + rr) : 0.f;
  const int kpad = (dk + 3) & ~3;
  const float* q_row = q + rr * dk;
  const float* g_row = g + rr * dv;
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  walk_word(bitmask, hind, task[kB0], task[kB1], words, kWarps * gr + warp, block_w, nk, k, v,
            dk, dv, 0, dv, vec_k && vec_v, nb, nbuf, ring, q_word, q_src, has_row,
            [&](const float* s) {
              const float raw = dot4<true>(q_row, s, dk, vec_k);
              const float p = expf(act(raw, scale, slope) - lse_r);
              const float dp = dot4<true>(g_row, s + kpad, dv, vec_v);
              const float ds = p * (dp - d_r) * act_grad(raw, slope) * scale;
              axpy_staged<kAcc>(ds, s + c0, cw, acc);
            });

  const bool vec_out = vec_k && cw % 4 == 0;
  const int rank = task[kRank];
  if (rank == 0) {
    if (has_row) store_row<kAcc>(dq + row * dk + c0, acc, cw, 1.f, vec_out);
  } else if (in_window) {
    const int64_t tr = (int64_t)(task[kSlot] + rank - 1) * tile_rows(words) + r;
    store_row<kAcc>(ws + tr * dk + c0, acc, cw, 1.f, vec_out);
  }
}

// acc[c] += coef * row[c] for c < cw, row in global memory (16-byte
// aligned when vec)
template <int kAcc>
__device__ __forceinline__ void axpy_row(float coef, const float* __restrict__ row, int cw,
                                         bool vec, float* acc) {
#pragma unroll
  for (int c = 0; c < kAcc; c += 4) {
    if (c < cw) {
      if (vec) {
        const float4 x = load4(row + c);
        acc[c] = fmaf(coef, x.x, acc[c]);
        acc[c + 1] = fmaf(coef, x.y, acc[c + 1]);
        acc[c + 2] = fmaf(coef, x.z, acc[c + 2]);
        acc[c + 3] = fmaf(coef, x.w, acc[c + 3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (c + t < cw) acc[c + t] = fmaf(coef, __ldg(row + c + t), acc[c + t]);
        }
      }
    }
  }
}

// The lane planes: thread i takes the i-th lane that holds a bit (lanes, in
// lane order), walks its bits in row order and writes its sums, columns
// [y kAcc, (y + 1) kAcc) of dk and of dv for chunk y, to its slot
// lane_slot[lane] of slot_k and slot_v.
template <int kAcc>
__global__ void __launch_bounds__(kThreads)
attn_bwd_lane_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                     const int32_t* __restrict__ hind,      // (B, K)
                     const int32_t* __restrict__ wob,       // (B,)
                     const int32_t* __restrict__ lanes,     // (n,) lanes with bits, in order
                     const int32_t* __restrict__ lane_slot, // (B * K,) slot of a lane
                     const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ drow,
                     float* __restrict__ slot_k,  // (n, dk)
                     float* __restrict__ slot_v,  // (n, dv)
                     int n, int words, int block_h, int block_w, int nq, int nk, int dk, int dv,
                     float scale, float slope, int vec_k, int vec_v) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c0 = blockIdx.y * kAcc;
  const int cwk = max(0, min(kAcc, dk - c0)), cwv = max(0, min(kAcc, dv - c0));
  const int64_t lane = __ldg(lanes + i);
  const int64_t b = lane / block_w;
  const int j = static_cast<int>(lane % block_w);
  const int64_t row0 = (int64_t)__ldg(wob + b) * block_h;
  const int rows = window_rows(row0, block_h, nq);
  const int64_t src = min(max(__ldg(hind + lane), 0), nk - 1);
  const float* k_src = k + src * dk;
  const float* v_src = v + src * dv;
  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc_k[c] = acc_v[c] = 0.f;
  // the lane's bits in row order, one edge a step: each lane moves on to
  // its next word by itself, so a warp takes as many steps as its busiest
  // lane has bits
  const int wend = min(words, (rows + 31) / 32);
  const uint32_t* wp = bitmask + b * words * block_w + j;
  int wd = 0;
  uint32_t word = wend > 0 ? __ldg(wp) : 0u;
  while (true) {
    while (word == 0u && ++wd < wend) word = __ldg(wp + (int64_t)wd * block_w);
    if (word == 0u) break;
    const int r = 32 * wd + __ffs(static_cast<int>(word)) - 1;
    word &= word - 1;
    if (r >= rows) break;
    const int64_t row = row0 + r;
    const float* q_row = q + row * dk;
    const float* g_row = g + row * dv;
    const float raw = dot4<false>(k_src, q_row, dk, vec_k);
    const float p = expf(act(raw, scale, slope) - __ldg(lse + row));
    if (cwk > 0) {
      const float dp = dot4<false>(v_src, g_row, dv, vec_v);
      const float ds = p * (dp - __ldg(drow + row)) * act_grad(raw, slope) * scale;
      axpy_row<kAcc>(ds, q_row + c0, cwk, vec_k, acc_k);
    }
    axpy_row<kAcc>(p, g_row + c0, cwv, vec_v, acc_v);
  }
  const int64_t slot = __ldg(lane_slot + lane);
  if (cwk > 0) store_row<kAcc>(slot_k + slot * dk + c0, acc_k, cwk, 1.f, vec_k);
  if (cwv > 0) store_row<kAcc>(slot_v + slot * dv + c0, acc_v, cwv, 1.f, vec_v);
}

// out[s] = the sum of slots offsets[s] .. offsets[s + 1] - 1 (0 for none).
// One warp per row s and chunk of kSumCols columns: cl lanes cover the
// chunk's columns four at a time and the warp's 32 / cl groups of them take
// every (32 / cl)-th slot, each group in order, kSumBatch loads at once;
// the groups' sums then add up by a shuffle tree. The order is fixed, so
// the sums are the same in every run, and a hub source's slots spread over
// the warp.
__global__ void __launch_bounds__(kThreads)
sum_slots_kernel(const float* __restrict__ slot, const int32_t* __restrict__ offsets,
                 float* __restrict__ out, int rows, int d, int cl) {
  const int s = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (s >= rows) return;
  const int c0 = blockIdx.y * kSumCols;
  const int cw = min(kSumCols, d - c0);
  const int groups = 32 / cl, grp = lane / cl, c = c0 + 4 * (lane % cl);
  const int x0 = __ldg(offsets + s), x1 = __ldg(offsets + s + 1);
  const bool vec = d % 4 == 0;
  auto load = [&](int64_t x) {  // columns c .. c + 3 of slot x
    if (vec) return __ldg(reinterpret_cast<const float4*>(slot + x * d + c));
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = slot + x * d + c;
    if (c < c0 + cw) y.x = __ldg(p);
    if (c + 1 < c0 + cw) y.y = __ldg(p + 1);
    if (c + 2 < c0 + cw) y.z = __ldg(p + 2);
    if (c + 3 < c0 + cw) y.w = __ldg(p + 3);
    return y;
  };
  const bool mine = c < c0 + cw;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = x0 + grp; x < x1; x += kSumBatch * groups) {
    float4 part[kSumBatch];
#pragma unroll
    for (int t = 0; t < kSumBatch; ++t) {
      if (mine && x + t * groups < x1) part[t] = load(x + t * groups);
    }
#pragma unroll
    for (int t = 0; t < kSumBatch; ++t) {
      if (mine && x + t * groups < x1) {
        a.x += part[t].x;
        a.y += part[t].y;
        a.z += part[t].z;
        a.w += part[t].w;
      }
    }
  }
  for (int o = cl; o < 32; o <<= 1) {  // the groups' sums, a fixed tree
    a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
  }
  if (grp == 0 && mine) {
    float* o = out + (int64_t)s * d + c;
    if (vec) {
      *reinterpret_cast<float4*>(o) = a;
    } else {
      o[0] = a.x;
      if (c + 1 < c0 + cw) o[1] = a.y;
      if (c + 2 < c0 + cw) o[2] = a.z;
      if (c + 3 < c0 + cw) o[3] = a.w;
    }
  }
}

cudaError_t launch_sum(const void* slot, const void* offsets, void* out, int rows, int d,
                       cudaStream_t s) {
  if (d == 0) return cudaSuccess;
  int cl = 1;  // lanes a chunk's columns take, four columns a lane
  while (cl < 32 && 4 * cl < min(d, kSumCols)) cl *= 2;
  sum_slots_kernel<<<dim3((rows + kWarps - 1) / kWarps, (d + kSumCols - 1) / kSumCols), kThreads,
                     0, s>>>(static_cast<const float*>(slot),
                             static_cast<const int32_t*>(offsets), static_cast<float*>(out),
                             rows, d, cl);
  return cudaGetLastError();
}

template <int kAcc>
int launch(const void* bitmask, const void* hind, const void* wob, const void* tasks,
           const void* merges, const void* lanes, const void* lane_slot, const void* offsets,
           const void* q, const void* k, const void* v, const void* g, const void* lse,
           const void* drow, void* dq, void* ws, void* slot_k, void* slot_v, void* dk_out,
           void* dv_out, int num_tasks, int num_merges, int n, int words, int block_h,
           int block_w, int nq, int nk, int dk, int dv, float scale, float slope, int vec_k,
           int vec_v, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = cudaSuccess;
  if (dk > 0) {  // dq, and its cut groups' merge
    auto walk = attn_bwd_dq_kernel<kAcc>;
    int nb, nbuf;
    walk_geometry(dk, dv, &nb, &nbuf);
    if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = smem_bytes(dk, dv, nb, nbuf);
    err = allow_smem(walk, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    walk<<<dim3(num_tasks, (dk + kAcc - 1) / kAcc), kThreads, smem, s>>>(
        static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
        static_cast<const int32_t*>(tasks), f(q), f(k), f(v), f(g), f(lse), f(drow),
        static_cast<float*>(dq), static_cast<float*>(ws), words, block_h, block_w, nq, nk, dk,
        dv, scale, slope, vec_k, vec_v, nb, nbuf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = voltrix_walk::launch_merge(merges, ws, dq, num_merges, words, block_h, nq, dk,
                                     dk % 4 == 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0) {  // the lanes with bits, into their source-order slots
    attn_bwd_lane_kernel<kAcc><<<dim3((n + kThreads - 1) / kThreads,
                                      (max(dk, dv) + kAcc - 1) / kAcc), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
        static_cast<const int32_t*>(wob), static_cast<const int32_t*>(lanes),
        static_cast<const int32_t*>(lane_slot), f(q), f(k), f(v), f(g), f(lse), f(drow),
        static_cast<float*>(slot_k), static_cast<float*>(slot_v), n, words, block_h, block_w,
        nq, nk, dk, dv, scale, slope, vec_k, vec_v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (offsets) {  // the slots summed by source row
    err = launch_sum(slot_k, offsets, dk_out, nk, dk, s);
    if (err == cudaSuccess) err = launch_sum(slot_v, offsets, dv_out, nk, dv, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launches K10 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take): the dq
// walk over `tasks` and, when a group is cut, its merge (`ws`: the cut
// groups' pieces 1.., tile_rows(words) x dk floats each), into dq; the
// lane pass over the n lanes that hold a bit (`lanes`, in lane order),
// each into row lane_slot[lane] of slot_k (n, dk) and slot_v (n, dv);
// and, with `offsets` (nk + 1 ints: source s's
// slots offsets[s] .. offsets[s + 1]), the sums of the slots into dk_out
// (nk, dk) and dv_out (nk, dv). Every row of dq, of the n slots and of
// dk_out and dv_out is written. acc is the column chunk a thread keeps (8,
// 16, 32, 40 or 64). vec_k: dk % 4 == 0 with q and k 16-byte aligned;
// vec_v: dv % 4 == 0 with v and dO aligned.
int voltrix_attn_bwd(const void* bitmask, const void* hind, const void* wob,
                     const void* tasks, const void* merges, const void* lanes,
                     const void* lane_slot, const void* offsets,
                     const void* q, const void* k, const void* v, const void* g, const void* lse,
                     const void* drow, void* dq, void* ws, void* slot_k, void* slot_v,
                     void* dk_out, void* dv_out, int num_tasks, int num_merges, int n, int words,
                     int block_h, int block_w, int nq, int nk, int dk, int dv, int acc,
                     float scale, float slope, int vec_k, int vec_v, void* stream) {
  if (num_tasks <= 0 || num_merges < 0 || n < 0 || words <= 0 || words * 32 < block_h ||
      block_h <= 0 || block_w <= 0 || nq <= 0 || nk <= 0 || dk < 0 || dv < 0 || dk + dv <= 0 ||
      (vec_k && dk % 4) || (vec_v && dv % 4) || (max(dk, dv) + acc - 1) / acc > 65535 ||
      (num_merges && !ws) || (offsets && (!dk_out || !dv_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLTRIX_BWD(N)                                                                     \
  case N:                                                                                  \
    return launch<N>(bitmask, hind, wob, tasks, merges, lanes, lane_slot, offsets, q, k, v, \
                     g, lse, drow, dq, ws, slot_k, slot_v, dk_out, dv_out, num_tasks,        \
                     num_merges, n, words, block_h, block_w, nq, nk, dk, dv, scale, slope,   \
                     vec_k, vec_v, s);
  switch (acc) {
    VOLTRIX_BWD(8)
    VOLTRIX_BWD(16)
    VOLTRIX_BWD(32)
    VOLTRIX_BWD(40)
    VOLTRIX_BWD(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOLTRIX_BWD
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

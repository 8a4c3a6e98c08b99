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
// and a second kernel, attn_fwd_merge_kernel, merges the shares in a fixed
// order: a warp per row takes the row's largest share maximum M once, its
// lanes rescale the shares by exp(m_share - M), four columns a lane, the
// lane groups over the shares each in piece order and then a fixed shuffle
// tree, so the output is the same in every run. No float atomics; no
// double sums (the order is fixed, so float32 repeats).
//
// Bound. Per edge 2 * (dk + dv) flops and an exp; the bytes are the plan,
// q, k, v, out and lse once each. The gathers of k and v rows, one per
// kept (lane, word) pair, and the hub window, whose hub row takes an edge
// in nearly every queued lane, one a step, separate it from the bound.

#include "attn_walk.cuh"

namespace {

using voltrix_attn::act;
using voltrix_attn::kEmptyLse;
using voltrix_attn::kNeg;
using namespace voltrix_attn_walk;
using voltrix_walk::kB0;
using voltrix_walk::kB1;
using voltrix_walk::kG;
using voltrix_walk::kMCount;
using voltrix_walk::kMergeInts;
using voltrix_walk::kMG;
using voltrix_walk::kMSlot;
using voltrix_walk::kMW;
using voltrix_walk::kRank;
using voltrix_walk::kSlot;
using voltrix_walk::kTaskInts;
using voltrix_walk::kW;
using voltrix_walk::tile_rows;

constexpr int kMergeCols = 128;  // columns of a merge thread block: four a lane
constexpr int kMergeBatch = 8;   // shares a merge lane loads at once

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
                      float* __restrict__ out, float* __restrict__ lse, int words, int block_h,
                      int nq, int dv, int cl) {
  const int tile = tile_rows(words);
  const int strips = tile / kWarps;
  const int* mg = merges + (int64_t)(blockIdx.x / strips) * kMergeInts;
  const int w = mg[kMW], g = mg[kMG], first = mg[kMSlot], count = mg[kMCount];
  const int r = (blockIdx.x % strips) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= group_rows(g, words, block_h)) return;
  const int64_t row = (int64_t)w * block_h + kWarps * 32 * g + r;
  const float* ml = ws_ml + ((int64_t)first * tile + r) * 2;
  const int64_t ml_stride = (int64_t)tile * 2;
  float big = kNeg;  // the row's largest share maximum, once for the row
  for (int p = lane; p < count; p += 32) big = fmaxf(big, ml[p * ml_stride]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));

  const int c0 = blockIdx.y * kMergeCols;
  const int cw = min(kMergeCols, dv - c0);
  const int groups = 32 / cl, grp = lane / cl, c = 4 * (lane % cl);
  const bool vec = dv % 4 == 0, mine = c < cw;
  const float* a0 = ws_acc + ((int64_t)first * tile + r) * dv + c0 + c;
  const int64_t a_stride = (int64_t)tile * dv;
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
  const int strips = tile_rows(words) / kWarps;
  int cl = 1;  // lanes a chunk's columns take, four columns a lane
  while (cl < 32 && 4 * cl < min(dv, kMergeCols)) cl *= 2;
  attn_fwd_merge_kernel<<<dim3(num_merges * strips, (dv + kMergeCols - 1) / kMergeCols),
                          kThreads, 0, s>>>(
      static_cast<const int32_t*>(merges), static_cast<const float*>(ws_ml),
      static_cast<const float*>(ws_acc), static_cast<float*>(out), static_cast<float*>(lse),
      words, block_h, nq, dv, cl);
  return static_cast<int>(cudaGetLastError());
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

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

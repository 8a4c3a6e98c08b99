// Kernel K5: the value gradient of the weighted SpMM, and the SDDMM,
// dV[b, r, l] = bit(b, r, l) ? g[w * block_h + r, :] . feat[hind[b, l], :] : 0
// for every block b of window w, a dense float32 (total_blocks, block_h,
// block_w) plane, for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/weighted.py:_dvalues_kernel together with
// the row gather it consumes there (a jnp.take with mode="clip") and the
// zero padding of g past num_nodes. The TPU computes the whole (block_h,
// block_w) product of each block on the MXU and masks it.
//
// Work list. The wrapper cuts each 128-row group of a window into pieces
// of at most PIECE_BLOCKS["spmm_dvalues"] consecutive blocks
// (ops/block_spmm.py:plan_walk, the task layout of csrc/spmm_walk.cuh), so
// a thread block takes a row's g values once for all the blocks of its
// piece. Every block of a group is in exactly one piece, and each block's
// plane rows are written by one warp: no workspace, no merge, no atomics.
//
// Design. One thread block of four warps per piece. Warp i takes one
// 32-row word of the group (warps share a word's blocks round robin when
// the group has fewer than four words), and lane r keeps row 32 * word + r
// of g in registers (zero past num_nodes), kD columns at a time. The warp
// walks its blocks' (block, 32-lane slice) units in order: each lane
// loads its lane's bitmask word and hind, and the lanes whose word is not
// zero gather their feat row (clipped hind) into a ring slot by cp.async,
// 16 bytes at a time where d % 4 == 0, the next unit in flight while this
// one is worked. 32 ballots turn the unit's words into each lane's mask of
// the lanes that hold its row's bit, and every lane takes one dot product
// per set bit, its columns in a fixed order, into a 32 x 32 shared tile;
// only the set bits cost arithmetic (about 2% of a block's slots on the
// arxiv proxy). Then the warp writes the unit's 32 rows x 32 lanes of the
// plane once, 16 bytes a lane, zeros and values together (a clear bit
// gives exactly 0.0, so the edge-slot scatter back to per-edge gradients
// is exact), with a streaming hint: the plane is not read again here.
//
// Bound. At the GAT widths (d = 8 and 40, block 64 x 128) the plane is 32 KB
// per block (416 MB on the ogbn-arxiv proxy with self-loops) and the
// arithmetic 2 d flops per set bit: the kernel is bound by device memory,
// the write of the plane. The bitmask, hind, g once and the gathered feat
// rows (from L2) are the rest of its traffic.

#include <cstdint>

#include <cuda_runtime.h>

#include "spmm_walk.cuh"

namespace {

using voltrix_walk::cp_async16;
using voltrix_walk::cp_async4;
using voltrix_walk::cp_async_commit;
using voltrix_walk::cp_async_wait;
using voltrix_walk::kB0;
using voltrix_walk::kB1;
using voltrix_walk::kG;
using voltrix_walk::kTaskInts;
using voltrix_walk::kThreads;  // 128: four warps
using voltrix_walk::kW;
using voltrix_walk::kWarps;

constexpr int kTilePitch = 36;  // floats between the tile's rows: 16-byte rows

// floats of a ring slot of n columns: padded to 16 bytes, then to an odd
// number of 16-byte units (lanes reading the same column of different
// slots fall in different banks)
__host__ __device__ inline int slot_floats(int n) {
  const int units = (n + 3) / 4;
  return 4 * (units % 2 ? units : units + 1);
}

// a warp's ring (two units of 32 slots) and tile
__host__ __device__ inline int warp_floats(int sf) { return 2 * 32 * sf + 32 * kTilePitch; }

template <int kD>
__global__ void __launch_bounds__(kThreads)
spmm_dvalues_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                    const int32_t* __restrict__ hind,      // (B, K)
                    const int32_t* __restrict__ tasks,     // (num_tasks, kTaskInts)
                    const float* __restrict__ feat,        // (source_rows, d)
                    const float* __restrict__ g,           // (num_nodes, d)
                    float* __restrict__ dv,                // (B, block_h, K)
                    int words, int block_h, int block_w, int num_nodes, int source_rows, int d,
                    int vec) {
  extern __shared__ __align__(16) float smem[];
  const int* task = tasks + (int64_t)blockIdx.x * kTaskInts;
  const int w = task[kW], grp = task[kG], b0 = task[kB0], b1 = task[kB1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gwords = min(kWarps, words - kWarps * grp);  // words of this group
  const int reps = kWarps / gwords;  // warps that share a word's blocks
  if (warp >= gwords * reps || b1 <= b0) return;
  const int wi = kWarps * grp + warp % gwords;  // the warp's word
  const int boff = warp / gwords;
  const int nblk = (b1 - b0 - boff + reps - 1) / reps;  // blocks b0 + boff + reps * i
  if (nblk <= 0) return;
  const int slices = block_w / 32;
  const int nchunks = (d + kD - 1) / kD;
  const int units = nblk * slices;
  const int steps = units * nchunks;
  const int sf = slot_floats(min(kD, d));
  float* ring = smem + warp * warp_floats(sf);
  float* tile = ring + 2 * 32 * sf;

  const int64_t grow = (int64_t)w * block_h + 32 * wi + lane;  // this lane's row of g
  const bool has_row = grow < num_nodes;
  float gr[kD];
  auto load_g = [&](int c0, int cw) {
    const float* src = g + grow * d + c0;
#pragma unroll
    for (int c = 0; c < kD; c += 4) {
      if (vec && has_row && c < cw) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + c));
        gr[c] = x.x, gr[c + 1] = x.y, gr[c + 2] = x.z, gr[c + 3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) gr[c + j] = has_row && c + j < cw ? __ldg(src + c + j) : 0.f;
      }
    }
  };
  load_g(0, min(kD, d));

  // unit u: slice u % slices of the warp's (u / slices)-th block
  auto block_of = [&](int u) { return (int64_t)b0 + boff + (int64_t)(u / slices) * reps; };
  auto load_unit = [&](int u, uint32_t& word, int32_t& src) {
    word = 0u;
    src = 0;
    if (u < units) {
      const int64_t b = block_of(u);
      const int j = (u % slices) * 32 + lane;
      word = __ldg(bitmask + (b * words + wi) * block_w + j);
      src = min(max(__ldg(hind + b * block_w + j), 0), source_rows - 1);  // mode="clip"
    }
  };
  // lane's feat row columns [c0, c0 + cw) into its slot of buffer buf
  auto stage = [&](uint32_t word, int32_t src, int st, int buf) {
    if (word != 0u && st < steps) {
      const int c0 = (st % nchunks) * kD, cw = min(kD, d - c0);
      float* slot = ring + (buf * 32 + lane) * sf;
      const float* row = feat + (int64_t)src * d + c0;
      if (vec) {
        for (int c = 0; c < cw; c += 4) cp_async16(slot + c, row + c);
      } else {
        for (int c = 0; c < cw; ++c) cp_async4(slot + c, row + c);
      }
    }
    cp_async_commit();
  };

  uint32_t cur_word, next_word, ahead_word;  // units u, u + 1, u + 2
  int32_t cur_src, next_src, ahead_src;
  load_unit(0, cur_word, cur_src);
  load_unit(1, next_word, next_src);
  load_unit(2, ahead_word, ahead_src);
  stage(cur_word, cur_src, 0, 0);
  uint32_t mask = 0u;  // the lanes that hold this lane's row's bit in the unit
  for (int st = 0; st < steps; ++st) {
    const int u = st / nchunks, ch = st % nchunks;
    const bool last = ch == nchunks - 1;  // the next step starts unit u + 1
    stage(last ? next_word : cur_word, last ? next_src : cur_src, st + 1, (st + 1) & 1);
    cp_async_wait<1>();
    __syncwarp();  // every lane's row of this step has landed; the tile is free
    if (ch == 0) {
      mask = 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const uint32_t b = __ballot_sync(0xffffffffu, (cur_word >> r) & 1u);
        if (lane == r) mask = b;
      }
    }
    const int c0 = ch * kD, cw = min(kD, d - c0);
    if (nchunks > 1 && ch > 0) load_g(c0, cw);
    const float* slots = ring + (st & 1) * 32 * sf;
    for (uint32_t m = mask; m;) {
      const int j = __ffs(static_cast<int>(m)) - 1;
      m &= m - 1u;
      const float* s = slots + j * sf;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < kD; c += 4) {
        if (c < cw) {
          const float4 y = *reinterpret_cast<const float4*>(s + c);
          s0 = fmaf(gr[c], y.x, s0);
          if (c + 1 < cw) s1 = fmaf(gr[c + 1], y.y, s1);
          if (c + 2 < cw) s2 = fmaf(gr[c + 2], y.z, s2);
          if (c + 3 < cw) s3 = fmaf(gr[c + 3], y.w, s3);
        }
      }
      const float dot = (s0 + s1) + (s2 + s3);
      float* t = tile + lane * kTilePitch + j;
      *t = ch == 0 ? dot : *t + dot;
    }
    if (nchunks > 1 && last) load_g(0, min(kD, d));
    __syncwarp();  // the tile is complete; this step's slots are read
    if (last) {
      // rows 4 i + lane / 8 of the unit, lanes q0 .. q0 + 3: zeros and values
      const int q0 = 4 * (lane % 8);
      const uint32_t w0 = __shfl_sync(0xffffffffu, cur_word, q0);
      const uint32_t w1 = __shfl_sync(0xffffffffu, cur_word, q0 + 1);
      const uint32_t w2 = __shfl_sync(0xffffffffu, cur_word, q0 + 2);
      const uint32_t w3 = __shfl_sync(0xffffffffu, cur_word, q0 + 3);
      float* dst = dv + (block_of(u) * block_h + 32 * wi) * block_w + (u % slices) * 32 + q0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 4 * i + lane / 8;
        const float4 t = *reinterpret_cast<const float4*>(tile + r * kTilePitch + q0);
        const float4 val = make_float4((w0 >> r) & 1u ? t.x : 0.f, (w1 >> r) & 1u ? t.y : 0.f,
                                       (w2 >> r) & 1u ? t.z : 0.f, (w3 >> r) & 1u ? t.w : 0.f);
        __stcs(reinterpret_cast<float4*>(dst + (int64_t)r * block_w), val);
      }
      cur_word = next_word, cur_src = next_src;
      next_word = ahead_word, next_src = ahead_src;
      load_unit(u + 3, ahead_word, ahead_src);
    }
  }
  cp_async_wait<0>();
}

template <int kD>
int launch(const void* bitmask, const void* hind, const void* tasks, const void* feat,
           const void* g, void* dv, int num_tasks, int words, int block_h, int block_w,
           int num_nodes, int source_rows, int d, int vec, cudaStream_t s) {
  auto kernel = spmm_dvalues_kernel<kD>;
  const int smem = kWarps * warp_floats(slot_floats(min(kD, d))) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<num_tasks, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(feat),
      static_cast<const float*>(g), static_cast<float*>(dv), words, block_h, block_w, num_nodes,
      source_rows, d, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K5 on `stream` over the work list `tasks` and returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// geometry it does not take: block_h and block_w must be multiples of 32).
// Every value of every block's plane is written once. kd is the column
// chunk a lane keeps in registers (8, 16, 32, 40 or 64); vec: d % 4 == 0
// with feat and g 16-byte aligned.
int voltrix_spmm_dvalues_f32(const void* bitmask, const void* hind, const void* tasks,
                             const void* feat, const void* g, void* dv, int num_tasks,
                             int words, int block_h, int block_w, int num_nodes,
                             int source_rows, int d, int kd, int vec, void* stream) {
  if (num_tasks <= 0 || words <= 0 || block_h <= 0 || block_h % 32 || words * 32 != block_h ||
      block_w <= 0 || block_w % 32 || num_nodes < 0 || source_rows <= 0 || d <= 0 ||
      (vec && d % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOLTRIX_DV(N)                                                                         \
  case N:                                                                                     \
    return launch<N>(bitmask, hind, tasks, feat, g, dv, num_tasks, words, block_h, block_w, \
                     num_nodes, source_rows, d, vec, s);
  switch (kd) {
    VOLTRIX_DV(8)
    VOLTRIX_DV(16)
    VOLTRIX_DV(32)
    VOLTRIX_DV(40)
    VOLTRIX_DV(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOLTRIX_DV
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

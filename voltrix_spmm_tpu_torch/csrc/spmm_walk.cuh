// The edge walk that kernels K1 (csrc/spmm_block.cu), K2
// (csrc/spmm_subtile.cu) and K8 (csrc/spmm_int8.cu) share: out[num_nodes, d]
// = A @ X over the binned block-CSR plan, for sm_90a. K2 is the walk with
// the sub-window occupancy test (kOcc); K1 and K8 are the walk without it.
// The walk is a template on its feature source: float32 rows of feat (K1,
// K2), 16-bit rows of width ld (a multiple of 4, 8-byte aligned; K1 and K2
// on bfloat16 or float16 features, each value widened exactly to float32
// as the TPU kernels' astype does, voltrix_spmm_tpu/ops/pallas_spmm.py:192,
// :263), or
// int8 rows q (source_rows, d4) with one float32 scale per row (K8), each
// value dequantized as bf16(float(q) * bf16(scale)) as the TPU kernel does
// (voltrix_spmm_tpu/ops/quant.py:47-50).
//
// Work list. The wrapper cuts each 128-row group of a window into pieces
// (ops/block_spmm.py:window_pieces, walk_tasks): block ranges that hold at
// most PIECE_BLOCKS blocks the walk visits (every block for K1 and K8, the
// blocks with the group's occupancy bit for K2) and at most about
// PIECE_WORK units of work (a kept (lane, word) pair and each of its
// nonzero bitmask bytes count one), so the dense hub blocks of a power-law
// graph get pieces of their own. A group without a visited block gets one
// empty piece, which writes its zeros. A task is one piece: the window, the
// group, the block range, the piece's rank among the group's pieces and the
// workspace slot of its tile. A group's cut depends on its window's blocks
// alone, so a window sums the same way in a window chunk
// (format/stream.py:slice_plan_windows) as in the whole plan.
//
// Walk. One thread block per (task, chunk of kCols = 128 feature columns),
// four warps. Warp i owns word 4 * group + i of the window (32 rows) and
// walks all of the piece's (block, 32-lane slice) units of that word; lane
// l keeps the sums of its 32 rows and four columns in registers. A lane
// loads its unit's bitmask word and hind kAhead units ahead; a ballot
// compacts the lanes with a bit and a hind inside the source rows, in lane
// order, into the warp's queue. Each queued item's row slice goes through
// cp.async into a ring of kStages slots, kStages - 1 items ahead of the one
// being summed: float32, lane l copies columns 4l..4l+3 (16 bytes) of a
// 512-byte slot, or, where d % 4 != 0 or feat is not 16-byte aligned,
// columns l, l + 32, l + 64, l + 96 with 4-byte copies (kF32x1); bf16 or
// float16, lane l copies columns 4l..4l+3 (8 bytes) of a 256-byte slot, half the
// float32 slot (cp.async has no 2-byte copy, so the wrapper pads rows whose
// width is not a multiple of 4 or that are not 8-byte aligned, once, into
// rows of width ld); int8, lane l copies its four columns' 4 bytes of a
// 128-byte slot, a quarter of the float32 ring. The 16-bit and int8 rings are
// twice as deep as the float32 one in the same shared memory. K8's scale travels with the
// item's hind through the queue: the lane that owns the lane slot loads it
// two units before the unit is queued. Lane l then adds its four columns
// (bf16: each widened by a 16-bit shift; float16: by a conversion, exact for
// every half, subnormals included) into the rows of the item's set
// bits, a byte of the word at a time,
// skipping zero bytes (the word is the same across the warp, so the tests
// do not diverge; constant indices keep the sums in registers). Each lane
// reads only what it copied, so the ring needs no barrier.
//
// Merge. Piece 0 of a group writes its tile to out, piece k >= 1 to its
// workspace slot (float32 for both sources). A group cut into n > 1 pieces
// is then summed by a second kernel, spmm_merge_kernel, in piece order,
// ((p0 + p1) + p2) + ..., a thread per four columns of a row, its loads
// issued kBatch at a time, so the result is the same in every run. No float
// atomics. Kernels K4 (csrc/spmm_weighted.cu) and K3 (csrc/spmm_fused.cu)
// take the same work list layout and merge (launch_merge) for their own
// products.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace voltrix_walk {

constexpr int kWarps = 4;  // one per 32-row word of a 128-row group
constexpr int kThreads = 32 * kWarps;
// thread blocks an SM holds: caps the walk at 168 registers a thread (the
// sums take 128) with no spills; more resident warps, not a deeper ring,
// is what shortened the walk on the H100
constexpr int kBlocksPerSm = 3;
constexpr int kCols = 128;  // feature columns per thread block, 4 per lane
// the feature source: float32 rows copied 16 or 4 bytes a lane, bfloat16
// or float16 rows copied 8 bytes a lane, or int8 rows with a float32 scale
// per row
enum { kF32x4, kF32x1, kI8, kBF16, kF16 };
// a 16-bit source: the same copies and ring, only the widening differs
template <int kSrc>
__host__ __device__ constexpr bool half_src() { return kSrc == kBF16 || kSrc == kF16; }
// row slices in flight per warp (cp.async ring)
template <int kSrc>
__host__ __device__ constexpr int stages() { return kSrc == kI8 || half_src<kSrc>() ? 32 : 16; }
// 4-byte words of a ring slot: kCols float32 columns, kCols 16-bit or int8 ones
template <int kSrc>
__host__ __device__ constexpr int slot_words() {
  return kSrc == kI8 ? kCols / 4 : half_src<kSrc>() ? kCols / 2 : kCols;
}
constexpr int kQueue = 64;  // kept items a warp holds: >= stages - 1 + 32
// per item in the queue: its bitmask word and source row (int8: and scale)
template <int kSrc>
__host__ __device__ constexpr int queue_arrays() { return kSrc == kI8 ? 3 : 2; }
constexpr int kAhead = 4;    // units whose bitmask word and hind are loaded ahead
constexpr int kMaxPiece = 256;  // blocks of a piece (ops/block_spmm.py MAX_PIECE_BLOCKS)
constexpr int kBatch = 8;      // workspace tiles a merge thread loads at once
constexpr int kTaskInts = 6;
// a task: window, group, block range [b0, b1), rank of the piece in its
// group, first workspace slot of the group (its piece 1; -1 if uncut)
enum { kW, kG, kB0, kB1, kRank, kSlot };
// a cut group: window, group, first workspace slot (its piece 1), pieces
constexpr int kMergeInts = 4;
enum { kMW, kMG, kMSlot, kMCount };
constexpr int kStripRows = kThreads / 32;  // rows a merge thread block sums

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst_s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst_s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst_s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and bulk copies (K3, csrc/spmm_fused.cu; K7's wide kernel,
// csrc/spmm_ell_dvals.cu)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// an arrival on `bar` that also expects `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// four bf16 values (8 bytes, the lower address in u.x's low half) widened
// exactly to float32: a bf16 is the high half of its float32
__device__ __forceinline__ float4 widen_bf16x4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// four float16 values (8 bytes, the lower address in u.x's low half)
// widened exactly to float32 (every half, subnormals included, is a float)
__device__ __forceinline__ float4 widen_f16x4(uint2 u) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  const float2 lo = __half22float2(h[0]), hi = __half22float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four values of 16-bit source kSrc (kBF16 or kF16) widened to float32
template <int kSrc>
__device__ __forceinline__ float4 widen16x4(uint2 u) {
  if constexpr (kSrc == kBF16) {
    return widen_bf16x4(u);
  } else {
    return widen_f16x4(u);
  }
}

template <int kSrc>
__host__ __device__ constexpr int smem_bytes() {
  return kWarps * (stages<kSrc>() * slot_words<kSrc>() + queue_arrays<kSrc>() * kQueue) * 4;
}

// rows of a workspace tile: the words of one group, 32 rows each (a group
// holds gw words: kWarps for the walk and K4, 8 for K3's tall windows)
__host__ __device__ inline int tile_rows(int words, int gw = kWarps) {
  return 32 * (words < gw ? words : gw);
}

// rows of group g of window w that lie inside the window and inside out
__device__ __forceinline__ int rows_out(int w, int g, int words, int block_h, int num_nodes,
                                        int gw = kWarps) {
  const int64_t row0 = (int64_t)w * block_h + gw * 32 * g;
  const int64_t left = (int64_t)num_nodes - row0;
  const int in_window = min(tile_rows(words - gw * g, gw), block_h - gw * 32 * g);
  return left < in_window ? (left > 0 ? (int)left : 0) : in_window;
}

template <bool kOcc, int kSrc>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
spmm_walk_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, block_w)
                 const int32_t* __restrict__ hind,      // (B, block_w)
                 const uint32_t* __restrict__ occ,      // (B,) sub-window bits (kOcc)
                 const int32_t* __restrict__ tasks,     // (num_tasks, kTaskInts)
                 const void* __restrict__ feat,         // (source_rows, ld) float32, 16-bit or int8
                 const float* __restrict__ scale,       // (source_rows,) (kI8)
                 float* __restrict__ out,               // (num_nodes, d)
                 float* __restrict__ ws,                // (slots, tile rows, d)
                 int words, int block_h, int block_w, int num_nodes, int source_rows,
                 int d, int ld) {
  constexpr int kStages = stages<kSrc>();
  constexpr int kSlotWords = slot_words<kSrc>();
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_blocks[kMaxPiece];
  __shared__ int s_nblk;

  const int* task = tasks + (int64_t)blockIdx.x * kTaskInts;
  const int w = task[kW], g = task[kG], b0 = task[kB0], b1 = task[kB1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gwords = min(kWarps, words - kWarps * g);
  const int c0 = blockIdx.y * kCols;
  const int cw = min(kCols, d - c0);   // output columns of the chunk
  const int lw = min(kCols, ld - c0);  // feature columns of the chunk (16-bit, int8: ld's)
  float* s_ring = smem + warp * kStages * kSlotWords;
  uint32_t* s_qword = reinterpret_cast<uint32_t*>(smem + kWarps * kStages * kSlotWords) +
                      warp * queue_arrays<kSrc>() * kQueue;
  int32_t* s_qsrc = reinterpret_cast<int32_t*>(s_qword + kQueue);
  float* s_qscale = reinterpret_cast<float*>(s_qsrc + kQueue);  // kI8 only

  // the piece's blocks, in order (K2: those with the group's occupancy bit;
  // at most kMaxPiece by the work list's construction)
  if (warp == 0) {
    int n = 0;
    for (int base = b0; base < b1; base += 32) {
      const int b = base + lane;
      bool keep = b < b1;
      if (kOcc && keep) keep = (occ[b] >> g) & 1u;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) s_blocks[n + __popc(ballot & ((1u << lane) - 1u))] = b;
      n += __popc(ballot);
    }
    if (lane == 0) s_nblk = n;
  }
  __syncthreads();
  if (warp >= gwords) return;

  // the lane's sums: row s of the warp's word, columns 4 lane .. 4 lane + 3
  // (kF32x4, kBF16, kF16, kI8) or lane + 32 k (kF32x1)
  float acc[32][4];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[s][k] = 0.f;
  }

  const int wi = kWarps * g + warp;
  const int slices = (block_w + 31) / 32;
  const int units = s_nblk * slices;
  // unit u is lane slice u % slices of the piece's (u / slices)-th block
  auto load_unit = [&](int u, uint32_t& word_out, int32_t& src_out) {
    word_out = 0u;
    src_out = -1;
    if (u < units) {
      const int64_t b = s_blocks[u / slices];
      const int j = (u % slices) * 32 + lane;
      if (j < block_w) {
        word_out = __ldg(bitmask + (b * words + wi) * block_w + j);
        src_out = __ldg(hind + b * block_w + j);
      }
    }
  };
  auto kept = [&](uint32_t word, int32_t src) {
    return word != 0u && src >= 0 && src < source_rows;
  };
  uint32_t next_word[kAhead];
  int32_t next_src[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load_unit(a, next_word[a], next_src[a]);
  // kI8: the scales of the next two units' kept lanes, loaded two units ahead
  float next_scale[2] = {0.f, 0.f};
  if constexpr (kSrc == kI8) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (kept(next_word[a], next_src[a])) next_scale[a] = __ldg(scale + next_src[a]);
    }
  }
  int u = 0, produced = 0;
  // queue the kept lanes of the next unit, in lane order
  auto produce = [&]() {
    const bool keep = kept(next_word[0], next_src[0]);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    __syncwarp();  // the queue slots about to be reused have been read
    if (keep) {
      const int pos = (produced + __popc(ballot & ((1u << lane) - 1u))) % kQueue;
      s_qword[pos] = next_word[0];
      s_qsrc[pos] = next_src[0];
      if constexpr (kSrc == kI8) s_qscale[pos] = bf16_round(next_scale[0]);
    }
    __syncwarp();
    produced += __popc(ballot);
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) {
      next_word[a] = next_word[a + 1];
      next_src[a] = next_src[a + 1];
    }
    if constexpr (kSrc == kI8) {
      next_scale[0] = next_scale[1];
      next_scale[1] = kept(next_word[1], next_src[1]) ? __ldg(scale + next_src[1]) : 0.f;
    }
    load_unit(u + kAhead, next_word[kAhead - 1], next_src[kAhead - 1]);
    ++u;
  };
  // queue items until item i exists or the units are spent (warp-uniform)
  auto ensure = [&](int i) {
    while (produced <= i && u < units) produce();
  };
  // item i's row slice into ring slot i % kStages; one commit group per call
  auto issue = [&](int i) {
    if (i < produced) {
      const int64_t src = s_qsrc[i % kQueue];
      float* slot = s_ring + (i % kStages) * kSlotWords;
      if constexpr (kSrc == kI8) {
        const int8_t* row = static_cast<const int8_t*>(feat) + src * ld + c0;
        if (4 * lane < lw) cp_async4(slot + lane, row + 4 * lane);
      } else if constexpr (half_src<kSrc>()) {
        const uint16_t* row = static_cast<const uint16_t*>(feat) + src * ld + c0;
        if (4 * lane < lw) cp_async8(slot + 2 * lane, row + 4 * lane);
      } else {
        const float* row = static_cast<const float*>(feat) + src * ld + c0;
        if constexpr (kSrc == kF32x4) {
          if (4 * lane < lw) cp_async16(slot + 4 * lane, row + 4 * lane);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = lane + 32 * k;
            if (c < lw) cp_async4(slot + c, row + c);
          }
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) {
    ensure(i);
    issue(i);
  }
  for (int t = 0; t < produced; ++t) {
    ensure(t + kStages - 1);
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();  // item t's slice has landed (this lane's copies)
    const uint32_t m = s_qword[t % kQueue];
    const float* slot = s_ring + (t % kStages) * kSlotWords;
    float x[4];
    if constexpr (kSrc == kI8) {
      const float sc = s_qscale[t % kQueue];
      const char4 q = 4 * lane < lw ? *reinterpret_cast<const char4*>(slot + lane)
                                    : make_char4(0, 0, 0, 0);
      x[0] = bf16_round(static_cast<float>(q.x) * sc);
      x[1] = bf16_round(static_cast<float>(q.y) * sc);
      x[2] = bf16_round(static_cast<float>(q.z) * sc);
      x[3] = bf16_round(static_cast<float>(q.w) * sc);
    } else if constexpr (half_src<kSrc>()) {
      const float4 v = 4 * lane < lw
                           ? widen16x4<kSrc>(*reinterpret_cast<const uint2*>(slot + 2 * lane))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else if constexpr (kSrc == kF32x4) {
      const float4 v = 4 * lane < lw ? *reinterpret_cast<const float4*>(slot + 4 * lane)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = lane + 32 * k < lw ? slot[lane + 32 * k] : 0.f;
    }
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) {
      if ((m >> (8 * byte)) & 0xffu) {
#pragma unroll
        for (int s = 8 * byte; s < 8 * byte + 8; ++s) {
          if ((m >> s) & 1u) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[s][k] += x[k];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // this warp's 32 rows of the tile: to out (piece 0) or the piece's slot
  const int rows = rows_out(w, g, words, block_h, num_nodes) - 32 * warp;
  const int rank = task[kRank];
  const int64_t row0 = (int64_t)w * block_h + kWarps * 32 * g + 32 * warp;
  float* dst = rank == 0 ? out + row0 * d + c0
                         : ws + ((int64_t)(task[kSlot] + rank - 1) * tile_rows(words) +
                                 32 * warp) * d + c0;
  // 16-byte stores where a row's four columns are whole and aligned
  const bool store4 = kSrc == kF32x4 || ((kSrc == kI8 || half_src<kSrc>()) && d % 4 == 0);
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    if (s < rows) {
      float* r = dst + (int64_t)s * d;
      if (kSrc == kF32x1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (lane + 32 * k < cw) r[lane + 32 * k] = acc[s][k];
        }
      } else if (store4) {
        if (4 * lane < cw) {
          *reinterpret_cast<float4*>(r + 4 * lane) =
              make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * lane + k < cw) r[4 * lane + k] = acc[s][k];
        }
      }
    }
  }
}

// The sum of each cut group's pieces, in piece order: out (piece 0) plus
// workspace slots first .. first + count - 2. One thread block per (cut
// group, kStripRows of its rows, column chunk, head); a warp per row, a
// lane per four columns. Head h's out and workspace start out_head and
// ws_head floats after head 0's (K14 and K15: one workspace per head).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
spmm_merge_kernel(const int32_t* __restrict__ merges,  // (cut groups, kMergeInts)
                  const float* __restrict__ ws,        // (heads, slots, tile rows, d)
                  float* __restrict__ out,             // (heads, num_nodes, d)
                  int words, int block_h, int num_nodes, int d, int gw, int64_t out_head,
                  int64_t ws_head) {
  out += blockIdx.z * out_head;
  ws += blockIdx.z * ws_head;
  const int strips = tile_rows(words, gw) / kStripRows;
  const int* mg = merges + (int64_t)(blockIdx.x / strips) * kMergeInts;
  const int w = mg[kMW], g = mg[kMG], first = mg[kMSlot], count = mg[kMCount];
  const int r = (blockIdx.x % strips) * kStripRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows_out(w, g, words, block_h, num_nodes, gw)) return;
  const int c0 = blockIdx.y * kCols;
  const int cw = min(kCols, d - c0);
  float* o = out + ((int64_t)w * block_h + gw * 32 * g + r) * d + c0;
  const int64_t slot_stride = (int64_t)tile_rows(words, gw) * d;
  const float* p = ws + (int64_t)first * slot_stride + (int64_t)r * d + c0;
  const int parts = count - 1;
  if (kVec == 4) {
    if (4 * lane >= cw) return;
    float4 v = *reinterpret_cast<const float4*>(o + 4 * lane);
    for (int k0 = 0; k0 < parts; k0 += kBatch) {
      float4 part[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k0 + k < parts) {
          part[k] = __ldg(reinterpret_cast<const float4*>(p + (k0 + k) * slot_stride +
                                                          4 * lane));
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k0 + k < parts) {
          v.x += part[k].x;
          v.y += part[k].y;
          v.z += part[k].z;
          v.w += part[k].w;
        }
      }
    }
    *reinterpret_cast<float4*>(o + 4 * lane) = v;
  } else {
    for (int c = lane; c < cw; c += 32) {
      float v = o[c];
      for (int k0 = 0; k0 < parts; k0 += kBatch) {
        float part[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (k0 + k < parts) part[k] = __ldg(p + (k0 + k) * slot_stride + c);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (k0 + k < parts) v += part[k];
        }
      }
      o[c] = v;
    }
  }
}

// Launches spmm_merge_kernel on `stream` when a group is cut: float4 loads
// and stores where `vec` (the rows are whole float4s; out and ws are fresh
// allocations, so 16-byte aligned then); a group holds gw words. Kernels K4
// (csrc/spmm_weighted.cu) and K3 (csrc/spmm_fused.cu, gw 8 on tall windows)
// call it after their own products, on the same work list layout; K14 and
// K15 (csrc/attn_mh_dq.cu, attn_mh_dkv.cu) for `heads` heads, head h's out
// and workspace out_head and ws_head floats on.
inline cudaError_t launch_merge(const void* merges, const void* ws, void* out, int num_merges,
                                int words, int block_h, int num_nodes, int d, bool vec,
                                cudaStream_t s, int gw = kWarps, int heads = 1,
                                int64_t out_head = 0, int64_t ws_head = 0) {
  if (num_merges == 0 || d == 0) return cudaSuccess;
  auto merge = vec ? spmm_merge_kernel<4> : spmm_merge_kernel<1>;
  const int strips = tile_rows(words, gw) / kStripRows;
  merge<<<dim3(num_merges * strips, (d + kCols - 1) / kCols, heads), kThreads, 0, s>>>(
      static_cast<const int32_t*>(merges), static_cast<const float*>(ws),
      static_cast<float*>(out), words, block_h, num_nodes, d, gw, out_head, ws_head);
  return cudaGetLastError();
}

// Launches the walk over `feat` (kSrc: float32 rows of width ld = d, bf16
// or float16 rows of width ld (a multiple of 4, >= d), or int8 rows of width ld = d4
// with `scale`) and, when a group is cut, the
// merge after it on `stream`; returns the first CUDA error as an int.
template <bool kOcc, int kSrc>
int launch_walk(const void* bitmask, const void* hind, const void* occ, const void* tasks,
                const void* merges, const void* feat, const void* scale, void* out, void* ws,
                int num_tasks, int num_merges, int words, int block_h, int block_w,
                int num_nodes, int source_rows, int d, int ld, void* stream) {
  auto walk = spmm_walk_kernel<kOcc, kSrc>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<kSrc>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (d + kCols - 1) / kCols;
  walk<<<dim3(num_tasks, chunks), kThreads, smem_bytes<kSrc>(), s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const uint32_t*>(occ), static_cast<const int32_t*>(tasks), feat,
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(ws),
      words, block_h, block_w, num_nodes, source_rows, d, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(merges, ws, out, num_merges, words, block_h, num_nodes,
                                       d, kSrc == kF32x4 || (kSrc != kF32x1 && d % 4 == 0), s));
}

}  // namespace voltrix_walk

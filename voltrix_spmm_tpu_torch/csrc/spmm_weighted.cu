// Kernel K4: the weighted SpMM, out[num_nodes, d] = (A o V) @ feat, over a
// plan that carries a dense value tile per block
// (voltrix_spmm_tpu_torch/format/plan.py, `values`), for sm_90a. The
// features are float32 or bfloat16 rows and the plane float32 or bfloat16
// (a template each): a bf16 value is widened exactly to float32 as it is
// read (a bf16 is the high half of its float32), as the TPU kernel's
// astype and jnp.dot's promotion do (voltrix_spmm_tpu/ops/weighted.py:46,
// :48), and the sums are float32 in the same order for every source, so
// the bf16 instantiations give the float32 kernel's bits on the widened
// rows and plane.
//
// Replaces voltrix_spmm_tpu/ops/weighted.py:_spmm_weighted_kernel together
// with the row gather it consumes there (a jnp.take with mode="clip"). As on
// the TPU, the whole value tile multiplies the gathered rows and the bitmask
// is not read: a value placed off the bitmask counts, zeros multiply too (0 *
// inf is NaN, as in JAX), and every lane's source row is clipped into
// [0, source_rows).
//
// Work list. The wrapper cuts each 128-row group of a window into pieces of
// at most PIECE_BLOCKS["spmm_weighted"] consecutive blocks
// (ops/block_spmm.py:window_pieces, walk_tasks, plan_walk: every block costs
// the same here, so there is no work limit), in the layout of
// csrc/spmm_walk.cuh. A window without blocks gets one empty piece, which
// writes its zeros, so every row of out is written. Piece 0 of a group
// writes out, piece k >= 1 its workspace slot, and spmm_walk.cuh's
// spmm_merge_kernel then sums a cut group's pieces in piece order. No float
// atomics, in global or shared memory: two launches on one input give the
// same bits.
//
// Product. One thread block per (piece, chunk of dc <= 64 feature columns,
// a multiple of 4). The piece's blocks are walked in units of kLanes = 32
// lanes: a unit is the group's rows x 32 lanes of one value tile (rows 144
// bytes apart in shared memory, so the 16-byte reads of 8 consecutive rows
// hit distinct banks) and the 32 lanes' source rows, dc columns each. Each
// unit is copied with cp.async into a ring of kStages slots, kStages - 1
// units ahead of the one being multiplied, so block b + 1's tile and rows
// are in flight while block b is multiplied; the value rows with an L2
// evict-first hint, the feature rows with 16-byte copies where d % 4 == 0
// and feat is 16-byte aligned, 4-byte copies otherwise; bf16 rows of width
// ld (a multiple of 4, 8-byte aligned: the wrapper pads other rows once,
// ops/block_spmm.py:bf16_rows, as cp.async has no 2-byte copy) with 8-byte
// copies, and a bf16 plane's rows of 32 lanes in four 16-byte copies (rows
// 80 bytes apart), each half the float32 bytes. Thread (rt, ct)
// sums rows rt + RT * i, i < TR (RT = rows / TR; TR 2, 4 or 8) of columns
// 4 ct .. 4 ct + 3 in registers: per four lanes it reads TR float4 values and
// four float4 rows of features and makes 16 TR fused multiply-adds, so a
// value is read once per four columns and a feature once per TR rows (the
// old kernel read each value once per column). Each sum runs over the
// piece's blocks in order and the lanes in order. Every thread copies: the
// value rows 16 bytes a thread, and the feature rows a whole row per warp
// request (a warp's lanes in groups of dc / 4, one row each), the rows'
// indices loaded one unit ahead by one lane each and passed by shuffle
// (a lane per source row, a request per row, was much slower at d 40).
//
// Bound. Every value tile is read once: at the GAT widths (d = 8 and 40,
// block 64 x 128) that is 32 KB per block (396.8 MiB on the ogbn-arxiv proxy,
// 0.124 ms at 3.35 TB/s) against 2 * 64 * 128 * d flops, so the kernel is
// bound by device memory at d = 8; at d = 40 the 4.2 GFMA of the dense tile
// products take ~0.14 ms on the float32 pipes (128 a clock on each of 132
// SMs), about the plane's time. What holds it on path D's plan (H100): at d
// 8 the value copies; at d 40 the product's 16-byte shared reads and the
// copies, which overlap only in part. The bf16 instantiations move half the
// plane's and rows' bytes but widen every value they read: on an NVIDIA H100
// 80GB HBM3 at 700 W, bf16 rows and plane take 0.193 / 0.478 ms on path D's
// plan at d 8 / 40 (float32 0.205 / 0.448 in turns) and 1.257 / 2.488 ms on
// DropEdge's plan of the ogbn-arxiv proxy at d 128 / 256 (float32 1.118 /
// 2.205): the bytes were not the limit.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmm_walk.cuh"

namespace {

using voltrix_walk::cp_async16;
using voltrix_walk::cp_async4;
using voltrix_walk::cp_async8;
using voltrix_walk::cp_async_commit;
using voltrix_walk::cp_async_wait;
using voltrix_walk::kBF16;
using voltrix_walk::kF32x1;
using voltrix_walk::kF32x4;
using voltrix_walk::widen_bf16x4;

constexpr int kLanes = 32;          // lanes of a value tile per unit
constexpr int kStages = 3;          // units in the cp.async ring (4 timed alike, 6 slower)
constexpr int kMaxThreads = 256;
constexpr int kGroupRows = 32 * voltrix_walk::kWarps;  // rows of a work-list group

// elements between value rows in shared memory: a float32 row's 32 lanes
// plus 4 (144 bytes), a bf16 row's plus 8 (80 bytes), so the reads of
// consecutive rows fall in different banks and every row starts 16-byte
// aligned
template <bool kValBF16>
__host__ __device__ constexpr int pitch() { return kValBF16 ? kLanes + 8 : kLanes + 4; }

// bytes of a ring stage: the group's value rows, then the unit's 32
// feature rows of dc columns (float32 or bf16)
template <int kSrc, bool kValBF16>
__host__ __device__ constexpr int stage_bytes(int rmax, int dc) {
  return rmax * pitch<kValBF16>() * (kValBF16 ? 2 : 4) + kLanes * dc * (kSrc == kBF16 ? 2 : 4);
}

// A 16-byte cp.async whose line L2 evicts first (`policy`): the value plane
// streams through once, and would otherwise push the feature rows, read
// again by other blocks, out of L2 (faster at d 8 on path D's plan).
__device__ __forceinline__ void cp_async16_stream(void* dst, const void* src, uint64_t policy) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst_s),
               "l"(src), "l"(policy)
               : "memory");
}

// four consecutive staged values (16-byte aligned float32, 8-byte aligned
// bf16) as floats
__device__ __forceinline__ float4 staged4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 staged4(const __nv_bfloat16* p) {
  return widen_bf16x4(*reinterpret_cast<const uint2*>(p));
}

// kSrc: float32 rows copied 16 bytes (kF32x4) or 4 bytes (kF32x1) at a
// time, or bf16 rows of width ld copied 8 bytes at a time (kBF16); V: the
// plane's type
template <int TR, int kSrc, typename V>
__global__ void __launch_bounds__(kMaxThreads, 2)
spmm_weighted_kernel(const V* __restrict__ values,       // (B, block_h, block_w)
                     const int32_t* __restrict__ hind,   // (B, block_w)
                     const int32_t* __restrict__ tasks,  // (num_tasks, kTaskInts)
                     const void* __restrict__ feat,      // (source_rows, ld)
                     float* __restrict__ out,            // (num_nodes, d)
                     float* __restrict__ ws,             // (slots, rmax, d)
                     int block_h, int block_w, int num_nodes, int source_rows, int d,
                     int ld, int dc) {
  using namespace voltrix_walk;
  using X = typename std::conditional<kSrc == kBF16, __nv_bfloat16, float>::type;
  constexpr bool kValBF16 = sizeof(V) == 2;
  constexpr int kPitch = pitch<kValBF16>();
  constexpr int kVecsPerRow = kLanes * sizeof(V) / 16;  // 16-byte copies of a value row
  constexpr int kPerCopy = kSrc == kF32x1 ? 1 : 4;       // feature values a copy moves
  extern __shared__ __align__(16) unsigned char smem[];
  const int rmax = min(block_h, kGroupRows);  // rows of a group's tile
  const int ct_n = dc / 4, rt_n = rmax / TR;
  const int t = threadIdx.x, nthreads = blockDim.x;  // a multiple of 32
  const int sbytes = stage_bytes<kSrc, kValBF16>(rmax, dc);
  const X* x_rows = static_cast<const X*>(feat);

  const int* task = tasks + (int64_t)blockIdx.x * kTaskInts;
  const int w = task[kW], g = task[kG], b0 = task[kB0], b1 = task[kB1];
  const int rows = min(kGroupRows, block_h - kGroupRows * g);  // rows of this group
  const int c0 = blockIdx.y * dc;
  const int cw = min(dc, d - c0);  // columns of this chunk; those past it are not stored
  const int slices = block_w / kLanes;
  const int units = (b1 - b0) * slices;
  // the feature rows of a unit's lanes: warp w copies lanes w * rpw ..
  // w * rpw + rpw - 1, whole rows, rpi rows a warp instruction of epr
  // copies each (so a row's bytes go in one coalesced request); the
  // warp's lane m holds the source row of its m-th lane
  const int wl = t % 32, warp = t / 32;
  const int rpw = (kLanes + nthreads / 32 - 1) / (nthreads / 32);
  const int epr = dc / kPerCopy;  // copies of a row
  const int rpi = epr >= 32 ? 1 : 32 / epr;
  const int lane0 = warp * rpw;

  // the source row of this warp's wl-th lane in unit u, clipped as
  // jnp.take(mode="clip")
  auto src_of = [&](int u) -> int {
    const int l = lane0 + wl;
    if (u >= units || wl >= rpw || l >= kLanes) return 0;
    const int64_t b = b0 + u / slices;
    const int src = __ldg(hind + b * block_w + (u % slices) * kLanes + l);
    return min(max(src, 0), source_rows - 1);
  };
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));
  // unit u's value rows and feature rows into ring slot u % kStages; one
  // commit group per call. src: src_of(u) (the same call in every lane)
  auto issue = [&](int u, int src) {
    if (u < units) {
      V* sv = reinterpret_cast<V*>(smem + (u % kStages) * sbytes);
      X* sx = reinterpret_cast<X*>(sv + rmax * kPitch);
      const V* v = values + ((int64_t)(b0 + u / slices) * block_h + kGroupRows * g) *
                                block_w + (u % slices) * kLanes;
      constexpr int kPer = 16 / sizeof(V);  // values a 16-byte copy moves
      for (int i = t; i < rows * kVecsPerRow; i += nthreads) {
        const int r = i / kVecsPerRow, q = i % kVecsPerRow;
        cp_async16_stream(sv + r * kPitch + kPer * q, v + (int64_t)r * block_w + kPer * q,
                          evict_first);
      }
      for (int k = 0; k < rpw; k += rpi) {
        const int m = k + (epr >= 32 ? 0 : wl / epr);  // the warp's lane this lane copies
        const int row = __shfl_sync(0xffffffffu, src, m < 32 ? m : 0);
        const int l = lane0 + m;
        if (m >= rpw || l >= kLanes || (epr < 32 && wl >= rpi * epr)) continue;
        const X* x = x_rows + (int64_t)row * ld + c0;
        X* dst = sx + l * dc;
        for (int e = epr >= 32 ? wl : wl % epr; e < epr; e += 32) {
          if (kPerCopy * e >= cw) continue;
          if constexpr (kSrc == kF32x4) {
            cp_async16(dst + 4 * e, x + 4 * e);
          } else if constexpr (kSrc == kBF16) {
            cp_async8(dst + 4 * e, x + 4 * e);
          } else {
            cp_async4(dst + e, x + e);
          }
        }
      }
    }
    cp_async_commit();
  };

  // the ring's first kStages - 1 units, their source rows loaded together
  int src0[kStages - 1];
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) src0[k] = src_of(k);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k, src0[k]);
  int src_ahead = src_of(kStages - 1);

  const bool computes = t < rt_n * ct_n;
  const int ct = t % ct_n, rt = t / ct_n;
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  }

  for (int u = 0; u < units; ++u) {
    const int src = src_ahead;
    src_ahead = src_of(u + kStages);  // used at the next step, after this product
    cp_async_wait<kStages - 2>();     // unit u's copies of this thread have landed
    __syncthreads();                  // and everyone's; slot (u - 1) % kStages is free
    issue(u + kStages - 1, src);
    if (computes) {
      const V* sv = reinterpret_cast<const V*>(smem + (u % kStages) * sbytes);
      const X* sx = reinterpret_cast<const X*>(sv + rmax * kPitch);
#pragma unroll
      for (int l = 0; l < kLanes; l += 4) {
        float4 x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = staged4(sx + (l + j) * dc + 4 * ct);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 v = staged4(sv + (rt + rt_n * i) * kPitch + l);
          const float vl[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(vl[j], x[j].x, acc[i][0]);
            acc[i][1] = fmaf(vl[j], x[j].y, acc[i][1]);
            acc[i][2] = fmaf(vl[j], x[j].z, acc[i][2]);
            acc[i][3] = fmaf(vl[j], x[j].w, acc[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!computes || 4 * ct >= cw) return;

  // the piece's tile: to out (piece 0) or the piece's workspace slot
  const int rank = task[kRank];
  const int64_t row0 = (int64_t)w * block_h + kGroupRows * g;
  float* dst = rank == 0 ? out + row0 * d
                         : ws + (int64_t)(task[kSlot] + rank - 1) * rmax * d;
  const int nrows = rows_out(w, g, block_h / 32, block_h, num_nodes);
  const int c = c0 + 4 * ct;
  // 16-byte stores where a row's four columns are whole and aligned
  const bool store4 = kSrc == kF32x4 || (kSrc == kBF16 && d % 4 == 0);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rt + rt_n * i;
    if (r >= nrows) continue;
    float* o = dst + (int64_t)r * d + c;
    if (store4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * ct + k < cw) o[k] = acc[i][k];
      }
    }
  }
}

template <int TR, int kSrc, typename V>
int launch(const void* values, const int32_t* hind, const int32_t* tasks, const int32_t* merges,
           const void* feat, float* out, float* ws, int num_tasks, int num_merges, int block_h,
           int block_w, int num_nodes, int source_rows, int d, int ld, int dc,
           cudaStream_t stream) {
  auto kernel = spmm_weighted_kernel<TR, kSrc, V>;
  const int rmax = block_h < kGroupRows ? block_h : kGroupRows;
  const int smem = kStages * stage_bytes<kSrc, sizeof(V) == 2>(rmax, dc);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (rmax / TR * (dc / 4) + 31) / 32 * 32;
  kernel<<<dim3(num_tasks, (d + dc - 1) / dc), threads, smem, stream>>>(
      static_cast<const V*>(values), hind, tasks, feat, out, ws, block_h, block_w, num_nodes,
      source_rows, d, ld, dc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = kSrc == kF32x4 || (kSrc == kBF16 && d % 4 == 0);
  return static_cast<int>(voltrix_walk::launch_merge(merges, ws, out, num_merges, block_h / 32,
                                                     block_h, num_nodes, d, vec, stream));
}

template <int TR, typename V>
int launch_src(int src, const void* values, const int32_t* hind, const int32_t* tasks,
               const int32_t* merges, const void* feat, float* out, float* ws, int num_tasks,
               int num_merges, int block_h, int block_w, int num_nodes, int source_rows, int d,
               int ld, int dc, cudaStream_t s) {
#define VOLTRIX_K4_SRC(SRC)                                                                  \
  case SRC:                                                                                \
    return launch<TR, SRC, V>(values, hind, tasks, merges, feat, out, ws, num_tasks,       \
                              num_merges, block_h, block_w, num_nodes, source_rows, d, ld, \
                              dc, s);
  switch (src) {
    VOLTRIX_K4_SRC(kF32x4)
    VOLTRIX_K4_SRC(kF32x1)
    VOLTRIX_K4_SRC(kBF16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOLTRIX_K4_SRC
}

}  // namespace

extern "C" {

// Launches K4 over the work list (tasks, merges: ops/block_spmm.py:plan_walk
// for "spmm_weighted") and, when a group is cut, the merge after it on
// `stream`; returns cudaGetLastError() as an int (0 on success;
// cudaErrorInvalidValue for a geometry it does not take). The wrapper
// (ops/weighted.py:k4_tiling) picks dc feature columns per chunk (a multiple
// of 4, at most 64) and tr rows per thread (2, 4 or 8, with at most 256
// threads). src: the features' source (spmm_walk.cuh): 0 (kF32x4) float32
// rows with 16-byte copies (d % 4 == 0, feat 16-byte aligned), 1 (kF32x1)
// float32 rows with 4-byte copies, 3 (kBF16) bf16 rows of width ld (a
// multiple of 4, >= d, 8-byte aligned); ld is d for float32 rows. val_bf16:
// the plane holds bf16 values, else float32 (16-byte aligned either way).
// `ws` holds the cut groups' pieces 1.. (slots x min(block_h, 128) x d
// floats), or is null when none is cut.
int voltrix_spmm_weighted(const void* values, const void* hind, const void* tasks,
                          const void* merges, const void* feat, void* out, void* ws,
                          int num_tasks, int num_merges, int block_h, int block_w, int num_nodes,
                          int source_rows, int d, int ld, int dc, int tr, int src, int val_bf16,
                          void* stream) {
  const auto* h = static_cast<const int32_t*>(hind);
  const auto* tk = static_cast<const int32_t*>(tasks);
  const auto* mg = static_cast<const int32_t*>(merges);
  auto* o = static_cast<float*>(out);
  auto* wsp = static_cast<float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  const int rmax = block_h < kGroupRows ? block_h : kGroupRows;
  const bool bf16_rows = src == kBF16;
  if (block_h <= 0 || block_h % 32 || block_w <= 0 || block_w % kLanes || dc < 4 ||
      dc > 64 || dc % 4 || tr <= 0 || rmax % tr || rmax / tr * (dc / 4) > kMaxThreads ||
      num_tasks <= 0 || d <= 0 || ld < d || (src == kF32x4 && d % 4) ||
      (bf16_rows && ld % 4) || (!bf16_rows && ld != d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define VOLTRIX_K4(TR)                                                                       \
  return val_bf16 ? launch_src<TR, __nv_bfloat16>(src, values, h, tk, mg, feat, o, wsp,      \
                                                  num_tasks, num_merges, block_h, block_w,   \
                                                  num_nodes, source_rows, d, ld, dc, s)      \
                  : launch_src<TR, float>(src, values, h, tk, mg, feat, o, wsp, num_tasks,   \
                                          num_merges, block_h, block_w, num_nodes,           \
                                          source_rows, d, ld, dc, s)
  switch (tr) {
    case 2: VOLTRIX_K4(2);
    case 4: VOLTRIX_K4(4);
    case 8: VOLTRIX_K4(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOLTRIX_K4
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

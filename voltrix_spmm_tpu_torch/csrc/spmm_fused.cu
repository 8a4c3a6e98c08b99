// Kernel K3: the coverage-fused SpMM, out[num_nodes, d] = A @ feat, over a
// coverage plan (gather_segment = seg >= 8), for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/pallas_spmm_fused.py:_fused_kernel, the TPU
// translation of the reference's producer/consumer kernel: X arrives in runs
// of seg consecutive source rows, one bulk copy per run, pipelined a few
// groups deep while the current group accumulates. Here the copies are
// cp.async.bulk into a ring of shared-memory stages completed on mbarriers.
//
// Work list. The wrapper cuts each slab of a window (gw 32-row words: 8 when
// the window has more than 4 words, else 4) into pieces of at most
// PIECE_BLOCKS["spmm_fused"] blocks and about PIECE_WORK["spmm_fused"] units
// of work (ops/block_spmm.py:window_pieces, walk_tasks, block_work; one
// task layout with the walk of csrc/spmm_walk.cuh). A slab's cut depends on
// its window's blocks alone, so a window sums the same way in a window chunk
// as in the whole plan. Piece 0 writes its tile to out, piece k >= 1 to a
// workspace slot, and spmm_walk.cuh's merge kernel adds the pieces in piece
// order: no float atomics, and two launches give the same bits.
//
// Design. One thread block per (task, chunk of kCols = 128 feature
// columns): a producer warp and the walking warps of the slab's words. The
// producer stages each 128-lane tile of the piece into a ring of
// shared-memory stages, up to stages - 1 tiles ahead: lane l takes tile
// rows l, l + 32, l + 64, l + 96 (a row's X row is the run head
// hind[b, (j / seg) * seg] plus j % seg, the heads loaded kAhead tiles
// ahead). A run's rows in the chunk come as boxes of a tensor map over
// feat (TMA: min(d, 128) columns by box_rows(seg) rows, the largest power
// of two dividing both seg and 128, so that every run edge and tile edge
// falls on a box edge), whose rows past source_rows read as zero; where
// d % 4 != 0, feat is not 16-byte aligned or a box would be under 8 rows,
// 4-byte cp.async (kF32x1 of the walk) and zeros written in the stage. Lane i < gw also copies word i's 128 bitmask words (cp.async.bulk). A
// stage's `full` mbarrier counts the producer's 32 arrivals and the bytes;
// its `empty` mbarrier the walking warps that are done with it, so warps
// drift apart by up to a ring's length and no barrier spans the block.
// The walks, by width:
//   wide (d > 32): two warps a word, each over 16 of its 32 rows; lane l
//     keeps the sums of those rows and columns 4l .. 4l + 3 of the chunk
//     in registers. A ballot keeps the tile lanes with a bit in the warp's
//     rows; two at a time, each kept lane's bits go round the warp by a
//     shuffle, the lane reads its four columns of that X row (one 16-byte
//     shared load, conflict-free), and adds them into the rows of the set
//     bits a byte at a time, skipping zero bytes: the bits are the same
//     across the warp, so the tests do not diverge and constant indices
//     keep the sums in registers. Each set bit is walked once per 128
//     columns.
//   narrow (d <= 32, path C's first layer at d 8): a warp a word, lane l
//     row l with all d columns in registers; for each kept tile lane the
//     warp reads that X row (a broadcast) and the lane whose row has the
//     bit adds it, so no lane idles on columns the row does not have.
// Every row has one owning warp and sums its bits in tile, lane and row
// order, so the result is the same in every run. A piece without blocks
// writes zeros.
//
// Resources (nvcc -Xptxas -v, sm_90a): the wide walk 94 registers (17
// warps, one thread block an SM: 3 stages of 68 KB at 128 columns), the
// narrow walk 71-72 (three thread blocks an SM, up to 8 stages); no spills.
//
// Bound. Bytes: the bitmask (C: 2.1 GiB, 0.67 ms at 3.35 TB/s), hind, X and
// out, each once. X is staged once per slab and column chunk: block_h /
// (32 gw) times per window (8 on the protein proxy's 2048-row windows),
// served mostly from L2. The walk costs a few instructions per kept (lane,
// word) pair and per nonzero byte of its word, and sets the time: on the
// protein proxy one column chunk takes as long at d 64 as at d 128.
//
// No tensor cores: at the protein proxy's fill (0.45%), a 16 x 8 tile of A
// holds a bit about 43% of the time, so an mma over binary tiles would do
// ~100x the useful work.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>

#include "spmm_walk.cuh"

namespace {

namespace vw = voltrix_walk;

constexpr int kTileLanes = 128;  // lanes of a block staged at once (a tile)
constexpr int kCols = 128;       // feature columns per thread block, 4 per lane
constexpr int kMaxWarps = 8;     // 32-row words of a slab
constexpr int kMaxStages = 8;
constexpr int kAhead = 4;  // tiles whose run heads the producer loads ahead
// dynamic shared memory the ring may take (227 KB less the static part)
constexpr int kSmemBudget = 227 * 1024 - 1024;

using vw::bulk_copy;
using vw::mbar_arrive;
using vw::mbar_arrive_expect_tx;
using vw::mbar_init;
using vw::mbar_wait;
using vw::smem_u32;

// rows of one tensor-map box: the largest power of two that divides both
// seg and a tile's 128 lanes. Runs start at multiples of seg and tiles at
// multiples of 128, so a box that starts at a multiple of box_rows in a
// tile lies within one run and one tile.
__host__ __device__ constexpr int box_rows(int seg) {
  return (seg & -seg) < kTileLanes ? (seg & -seg) : kTileLanes;
}

// a box of the 2-D tensor map at column c, row r, to shared `dst`
// (128-byte aligned), completing on `bar`; rows past the tensor read as
// zero
__device__ __forceinline__ void tma_copy(void* dst, const CUtensorMap* map, int c, int r,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The producer warp: lane l stages rows l, l + 32, l + 64, l + 96 of each
// tile (a box of box_rows(seg) rows at each such row that is a multiple of
// it) and, for l < nw, word l's 128 bitmask
// words, up to stages - 1 tiles ahead of the walk. The run heads of tile t
// (hind) are loaded kAhead tiles before its copies are issued, into
// registers that an unrolled loop indexes with constants.
template <bool kBulk>
__device__ __forceinline__ void produce_tiles(
    const uint32_t* __restrict__ bitmask, const int32_t* __restrict__ hind,
    const float* __restrict__ feat, const CUtensorMap* xmap, float* smem, uint64_t* full,
    uint64_t* empty, int b0, int tiles, int tpb, int words, int gw, int g, int nw, int block_w,
    int seg, int source_rows, int d, int c0, int cw, int pitch, int stage_floats, int stages) {
  constexpr int kRows = kTileLanes / 32;  // tile rows a lane stages
  const int lane = threadIdx.x % 32;
  const int box = box_rows(seg);  // rows of a box, within one run
  int q[kAhead][kRows];                 // the source rows of the next kAhead tiles
  auto heads = [&](int t, int (&r)[kRows]) {
    if (t >= tiles) return;
    const int64_t b = b0 + t / tpb;
    const int lane0 = (t % tpb) * kTileLanes;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = lane0 + 32 * k + lane;
      r[k] = __ldg(hind + b * block_w + (j - j % seg)) + j % seg;
    }
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) heads(i, q[i]);
  for (int t0 = 0; t0 < tiles; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t >= tiles) break;
      int rows[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) rows[k] = q[i][k];
      heads(t + kAhead, q[i]);
      const int st = t % stages;
      if (t >= stages) mbar_wait(&empty[st], (t / stages - 1) & 1);
      const int64_t b = b0 + t / tpb;
      const int lane0 = (t % tpb) * kTileLanes;
      float* xs = smem + st * stage_floats;
      uint32_t* ms = reinterpret_cast<uint32_t*>(xs + kTileLanes * pitch);
      const uint32_t* mrow = bitmask + (b * words + gw * g + lane) * block_w + lane0;
      if constexpr (kBulk) {
        // the tile's rows as boxes, each within one run (rows past X read
        // as zero), and the slab's bitmask words
        uint32_t total = lane < nw ? kTileLanes * 4 : 0;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if ((32 * k + lane) % box == 0) total += box * pitch * 4;
        }
        mbar_arrive_expect_tx(&full[st], total);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int r = 32 * k + lane;
          if (r % box == 0) tma_copy(xs + r * pitch, xmap, c0, rows[k], &full[st]);
        }
        if (lane < nw) bulk_copy(ms + lane * kTileLanes, mrow, kTileLanes * 4, &full[st]);
      } else {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {  // a row past X reads as zero
          float* x = xs + (32 * k + lane) * pitch;
          if (rows[k] < 0 || rows[k] >= source_rows) {
            for (int c = 0; c < pitch; c += 4) {
              *reinterpret_cast<float4*>(x + c) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (rows[k] >= 0 && rows[k] < source_rows) {
            const float* src = feat + (int64_t)rows[k] * d + c0;
            float* x = xs + (32 * k + lane) * pitch;
            for (int c = 0; c < cw; ++c) vw::cp_async4(x + c, src + c);
          }
        }
        if (lane < nw) {
          for (int c = 0; c < kTileLanes; c += 4) {
            vw::cp_async16(ms + lane * kTileLanes + c, mrow + c);
          }
        }
        cp_async_arrive(&full[st]);
      }
    }
  }
}

// walking warps a word: the wide walk splits a word's 32 rows between two
// warps (16 rows of sums a lane), so twice the warps hide its latencies
template <int kNC>
__host__ __device__ constexpr int warps_per_word() { return kNC ? 1 : 2; }

// kNC = 0: the wide walk (a warp per 16 rows of a word, lane l: columns
// 4l .. 4l + 3 of the chunk). kNC > 0: the narrow walk for d <= 4 kNC <= 32
// (a warp per word, lane l: row l, kNC float4 of columns).
template <bool kBulk, int kNC>
__global__ void __launch_bounds__(32 * (kMaxWarps * warps_per_word<kNC>() + 1), kNC ? 3 : 1)
spmm_fused_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, block_w)
                  const int32_t* __restrict__ hind,      // (B, block_w)
                  const int32_t* __restrict__ tasks,     // (num_tasks, kTaskInts)
                  const float* __restrict__ feat,        // (source_rows, d)
                  float* __restrict__ out,               // (num_nodes, d)
                  float* __restrict__ ws,                // (slots, tile rows, d)
                  const __grid_constant__ CUtensorMap xmap,  // feat (bulk copies)
                  int words, int gw, int block_h, int block_w, int seg, int num_nodes,
                  int source_rows, int d, int chunks, int stages) {
  constexpr int kWpw = warps_per_word<kNC>();
  constexpr int kRowsPerWarp = 32 / kWpw;
  // stages x [(kTileLanes, pitch) X rows, (gw, kTileLanes) bitmask words]
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];   // the stage's copies have landed
  __shared__ __align__(8) uint64_t empty[kMaxStages];  // the walking warps are done with it

  const int* task = tasks + (int64_t)(blockIdx.x / chunks) * vw::kTaskInts;
  const int w = task[vw::kW], g = task[vw::kG], b0 = task[vw::kB0], b1 = task[vw::kB1];
  const int c0 = (blockIdx.x % chunks) * kCols;
  const int cw = min(kCols, d - c0);
  // floats between staged rows: a box's width, or cp.async's rows
  const int pitch = kBulk ? (d < kCols ? d : kCols) : (cw + 3) & ~3;
  const int stage_floats = kTileLanes * pitch + gw * kTileLanes;
  const int nw = min(gw, words - gw * g);  // words of this slab
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tpb = block_w / kTileLanes;
  const int tiles = (b1 - b0) * tpb;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], nw * kWpw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == gw * kWpw) {
    produce_tiles<kBulk>(bitmask, hind, feat, &xmap, smem, full, empty, b0, tiles, tpb, words,
                         gw, g, nw, block_w, seg, source_rows, d, c0, cw, pitch, stage_floats,
                         stages);
    return;
  }
  if (warp >= nw * kWpw) return;
  const int wi = warp / kWpw;                    // the word this warp walks
  const int r0 = (warp % kWpw) * kRowsPerWarp;  // its first row in the word

  // a walking warp's sums, in registers: the wide walk's row r0 + s,
  // columns c0 + 4 lane .. + 3; the narrow walk's row lane, columns
  // 4k .. 4k + 3
  constexpr int kAcc = kNC ? 1 : kRowsPerWarp;
  constexpr int kVecs = kNC ? kNC : 1;
  float4 acc[kAcc][kVecs];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) acc[s][k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool col_ok = 4 * lane < cw;
  // the wide walk: x into the rows of `bits` (this warp's rows), a byte at a
  // time, skipping zero bytes; `bits` is the same across the warp, so the
  // tests do not diverge, and constant indices keep the sums in registers
  auto add_rows = [&](uint32_t bits, float4 x) {
#pragma unroll
    for (int byte = 0; byte < kRowsPerWarp / 8; ++byte) {
      if ((bits >> (8 * byte)) & 0xffu) {
#pragma unroll
        for (int s = 8 * byte; s < 8 * byte + 8; ++s) {
          if ((bits >> s) & 1u) {
            acc[s % kAcc][0].x += x.x;
            acc[s % kAcc][0].y += x.y;
            acc[s % kAcc][0].z += x.z;
            acc[s % kAcc][0].w += x.w;
          }
        }
      }
    }
  };
  for (int t = 0; t < tiles; ++t) {
    const int st = t % stages;
    mbar_wait(&full[st], (t / stages) & 1);
    const float* xs = smem + st * stage_floats;
    const uint32_t* ms =
        reinterpret_cast<const uint32_t*>(xs + kTileLanes * pitch) + wi * kTileLanes;
#pragma unroll
    for (int sl = 0; sl < kTileLanes / 32; ++sl) {
      const float* xsl = xs + sl * 32 * pitch;
      if constexpr (kNC) {
        const uint32_t m = ms[sl * 32 + lane];
        unsigned kept = __ballot_sync(0xffffffffu, m != 0u);
        while (kept) {  // the lanes whose word has a bit, in lane order
          const int src = __ffs(kept) - 1;
          kept &= kept - 1;
          // every lane reads the same row (a broadcast); the lane whose
          // row has the bit adds it
          const bool mine = (__shfl_sync(0xffffffffu, m, src) >> lane) & 1u;
          const float* xrow = xsl + src * pitch;
#pragma unroll
          for (int k = 0; k < kNC; ++k) {
            if (4 * k < cw) {
              const float4 x = *reinterpret_cast<const float4*>(xrow + 4 * k);
              if (mine) {
                acc[0][k].x += x.x;
                acc[0][k].y += x.y;
                acc[0][k].z += x.z;
                acc[0][k].w += x.w;
              }
            }
          }
        }
      } else {
        // this warp's rows of each lane's word; the lanes with a bit there,
        // two at a time, so their shuffles and loads overlap
        const uint32_t m = (ms[sl * 32 + lane] >> r0) & ((1u << kRowsPerWarp) - 1u);
        unsigned kept = __ballot_sync(0xffffffffu, m != 0u);
        while (kept) {
          const int s1 = __ffs(kept) - 1;
          kept &= kept - 1;
          const bool two = kept != 0u;
          const int s2 = two ? __ffs(kept) - 1 : s1;
          if (two) kept &= kept - 1;
          const uint32_t bits1 = __shfl_sync(0xffffffffu, m, s1);
          const uint32_t bits2 = two ? __shfl_sync(0xffffffffu, m, s2) : 0u;
          float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f), x2 = x1;
          if (col_ok) {
            x1 = *reinterpret_cast<const float4*>(xsl + s1 * pitch + 4 * lane);
            x2 = *reinterpret_cast<const float4*>(xsl + s2 * pitch + 4 * lane);
          }
          add_rows(bits1, x1);
          add_rows(bits2, x2);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with tile t's stage
  }

  // this warp's rows of the slab's tile: to out (piece 0) or the piece's slot
  const int rows = vw::rows_out(w, g, words, block_h, num_nodes, gw) - 32 * wi - r0;
  const int rank = task[vw::kRank];
  const int64_t row0 = (int64_t)w * block_h + gw * 32 * g + 32 * wi + r0;
  float* dst = rank == 0 ? out + row0 * d + c0
                         : ws + ((int64_t)(task[vw::kSlot] + rank - 1) * vw::tile_rows(words, gw) +
                                 32 * wi + r0) * d + c0;
  const bool store4 = d % 4 == 0;
  auto store = [&](float* o, float4 v, int c) {  // columns c .. c + 3 of a row
    if (store4) {
      *reinterpret_cast<float4*>(o + c) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c + k < cw) o[c + k] = e[k];
      }
    }
  };
  if constexpr (kNC) {
    if (lane < rows) {
#pragma unroll
      for (int k = 0; k < kNC; ++k) {
        if (4 * k < cw) store(dst + (int64_t)lane * d, acc[0][k], 4 * k);
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kAcc; ++s) {
      if (s < rows && col_ok) store(dst + (int64_t)s * d, acc[s][0], 4 * lane);
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

}  // namespace

extern "C" {

// Launches K3 (the walk, then the merge of cut slabs) on `stream` and
// returns the first CUDA error as an int (0 on success). All pointers are
// device pointers; `bitmask` holds uint32 words; `tasks`, `merges` and `ws`
// are laid out as in spmm_walk.cuh with groups of gw (4 or 8) words (ws may
// be null when no slab is cut). block_w is a multiple of 128; seg >= 8
// divides block_w. bulk = 1 iff d % 4 == 0, feat is 16-byte aligned and
// box_rows(seg) >= 8 (a box's rows then start 128-byte aligned in shared
// memory); bulk = 0 takes 4-byte cp.async.
int voltrix_spmm_fused_f32(const void* bitmask, const void* hind, const void* tasks,
                           const void* merges, const void* feat, void* out, void* ws,
                           int num_tasks, int num_merges, int words, int gw, int block_h,
                           int block_w, int seg, int num_nodes, int source_rows, int d, int bulk,
                           void* stream) {
  if (num_tasks <= 0 || d <= 0 || (gw != 4 && gw != kMaxWarps) || block_w % kTileLanes ||
      seg < 1 || block_w % seg || (bulk && box_rows(seg) < 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (d + kCols - 1) / kCols;
  const int cw = d < kCols ? d : kCols;
  const int pitch = bulk ? cw : (cw + 3) & ~3;
  // the staged rows come as (cw, box_rows(seg)) boxes of a tensor map over
  // feat
  CUtensorMap xmap;
  std::memset(&xmap, 0, sizeof(xmap));
  if (bulk && source_rows > 0) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(source_rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(cw),
                               static_cast<cuuint32_t>(box_rows(seg))};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(feat), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int stage_bytes = (kTileLanes * pitch + gw * kTileLanes) * 4;
  // the narrow walk (d <= 32) leaves room for three thread blocks an SM
  int stages = (d <= 32 ? kSmemBudget / 3 : kSmemBudget) / stage_bytes;
  stages = stages < kMaxStages ? stages : kMaxStages;
  stages = stages > 2 ? stages : 2;
  const int smem = stages * stage_bytes;
  // the narrow walk for rows of up to 32 floats, by its float4 per row
  auto pick = [&](auto b) {
    constexpr bool kB = decltype(b)::value;
    return d <= 8    ? spmm_fused_kernel<kB, 2>
           : d <= 16 ? spmm_fused_kernel<kB, 4>
           : d <= 32 ? spmm_fused_kernel<kB, 8>
                     : spmm_fused_kernel<kB, 0>;
  };
  auto kernel = bulk ? pick(std::true_type{}) : pick(std::false_type{});
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((int64_t)num_tasks * chunks > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  const int walkers = gw * (d <= 32 ? warps_per_word<2>() : warps_per_word<0>());
  kernel<<<num_tasks * chunks, 32 * (walkers + 1), smem, s>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(feat),
      static_cast<float*>(out), static_cast<float*>(ws), xmap, words, gw, block_h, block_w, seg,
      num_nodes, source_rows, d, chunks, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vw::launch_merge(merges, ws, out, num_merges, words, block_h, num_nodes,
                                           d, d % 4 == 0, s, gw));
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

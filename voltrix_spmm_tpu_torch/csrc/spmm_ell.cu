// Kernel K6: the ELL SpMM, out[num_nodes, d] = (A o V) @ feat, over the
// edge-per-lane plan (voltrix_spmm_tpu_torch/format/ell.py), for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/ell.py:_ell_fwd_kernel together with the
// row gather it consumes there (a jnp.take with mode="clip"). The TPU
// rebuilds each block's (block_h, block_w) value tile with a compare
// against a row iota and multiplies it by the gathered rows on the MXU:
// block_h times the work the edges need. Here each lane is one edge and
// adds only into its own row: out[w * block_h + erow[l]] += vals[l] *
// feat[hind[l]]. A padding lane (erow = -1) is left out of the walk, so it
// adds nothing whatever `vals` holds there, as the iota compare never
// matches -1 on the TPU.
//
// Design: rows, not lanes. The lanes of a window are sorted by (column,
// row), so consecutive lanes hit scattered rows; summing them in lane order
// needs atomics, and float atomics sum in another order in every run. The
// wrapper builds a row order once per plan (ops/ell.py:ell_row_order): the
// plan's non-padding lanes grouped by destination row, in lane order within
// a row, each lane's source row (clipped as jnp.take does) beside its flat
// lane index. A row is cut into pieces of at most PIECE_LANES lanes, so a
// hub row of a power-law graph spreads over many SMs, and every row, an
// empty one too, is at least one piece (an item). One warp per (item, chunk
// of tpe * vec feature columns): tpe threads cover the chunk, vec columns
// each (float4 loads when d % 4 == 0 and feat is 16-byte aligned), and the
// warp's 32 / tpe edge slots take the item's lanes s, s + slots, ... ; a
// thread gathers kUnroll edges at a time and loads the next step's source
// rows and lanes a step ahead, then adds value x row into float32 sums in
// registers, in lane order. The slots are summed by a fixed xor-shuffle
// tree. Piece 0 of a row writes out, piece k >= 1 its workspace row; the
// merge kernel then adds a cut row's pieces in piece order, ((p0 + p1) +
// p2) + ... No float atomics: two launches on one input give the same bits,
// and a window's rows sum the same way in a window chunk of the plan
// (format/ell.py:slice_ell_windows), whose row order is the whole plan's
// for those rows. Every row of out is written, zeros included.
//
// Resources (nvcc -Xptxas -v, sm_90a): the row walk 26 to 48 registers a
// thread by (vec, unroll), the merge 40 / 56, no spills, no shared memory.
//
// Bound. Per edge the kernel reads its source row and lane (8 bytes), the
// value (4) and one row of feat; the bound counts each input once (feat
// stays in the 50 MB L2 on the ogbn-arxiv and ogbl-ddi proxies), so the
// dependent gathers, not the flops (2 per edge and column), separate the
// kernel from its bound. On an NVIDIA H100 80GB HBM3 at 700 W it takes
// 0.062 / 0.117 ms at d 8 / 40 on the ogbn-arxiv proxy with self-loops
// (torch.sparse.mm 0.164 / 0.198; bound 0.012 / 0.025) and 0.624 ms at
// d 256 on the ogbl-ddi proxy's 5.1M link candidates (0.656; bound 0.039),
// at PIECE_LANES 512 (tools/k6_piece_sweep.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps per thread block, one item each
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 8;  // workspace rows a merge thread loads at once
// an item: destination row, its lanes [begin, end) in the row order, and
// its workspace row (-1: piece 0, written to out)
constexpr int kItemInts = 4;
enum { kRow, kBegin, kEnd, kSlot };
// a cut row: the row, the workspace row of its piece 1, its pieces
constexpr int kMergeInts = 3;
enum { kMRow, kMSlot, kMCount };

template <int kVec>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[kVec]) {
  if (kVec == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[kVec]) {
  if (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

template <int kVec, int kUnroll>
__global__ void __launch_bounds__(kThreads)
spmm_ell_rows_kernel(const int32_t* __restrict__ items,  // (num_items, kItemInts)
                     const int32_t* __restrict__ src,    // (kept lanes,) in row order
                     const int32_t* __restrict__ lane,   // (kept lanes,) flat lane index
                     const float* __restrict__ vals,     // (B * K,)
                     const float* __restrict__ feat,     // (source_rows, d)
                     float* __restrict__ out,            // (num_nodes, d)
                     float* __restrict__ ws,             // (slots, d)
                     int num_items, int d, int tpe) {
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const int64_t item = (int64_t)blockIdx.x * kWarps + warp;
  if (item >= num_items) return;
  const int* it = items + item * kItemInts;
  const int row = it[kRow], begin = it[kBegin], end = it[kEnd], slot = it[kSlot];
  const int slots = 32 / tpe;  // edge slots of the warp
  const int s = lane_id / tpe;
  const int c = (blockIdx.y * tpe + lane_id % tpe) * kVec;
  const bool col_ok = c < d;
  const int step = slots * kUnroll;

  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  // the next step's source rows (-1 past the item's end) and lanes
  int nsrc[kUnroll], nlane[kUnroll];
  auto load_step = [&](int e0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + s + slots * u;
      nsrc[u] = e < end ? __ldg(src + e) : -1;
      nlane[u] = e < end ? __ldg(lane + e) : 0;
    }
  };
  load_step(begin);
  for (int e0 = begin; e0 < end; e0 += step) {
    int csrc[kUnroll], clane[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      csrc[u] = nsrc[u];
      clane[u] = nlane[u];
    }
    load_step(e0 + step);
    float v[kUnroll];
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = 0.f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) x[u][k] = 0.f;
      if (csrc[u] >= 0) {
        v[u] = __ldg(vals + clane[u]);
        if (col_ok) load_cols<kVec>(feat + (int64_t)csrc[u] * d + c, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (csrc[u] >= 0) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] += v[u] * x[u][k];
      }
    }
  }
  // the edge slots' sums, in a fixed tree order (a + b == b + a, so every
  // lane of a column ends with the same bits)
  for (int o = 16; o >= tpe; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  }
  if (s != 0 || !col_ok) return;
  float* dst = (slot < 0 ? out + (int64_t)row * d : ws + (int64_t)slot * d) + c;
  store_cols<kVec>(dst, acc);
}

// The sum of each cut row's pieces, in piece order: out (piece 0) plus
// workspace rows first .. first + count - 2. One warp per (cut row, chunk
// of 32 * kVec columns), a lane per kVec columns, its loads issued kBatch
// at a time.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
spmm_ell_merge_kernel(const int32_t* __restrict__ merges,  // (cut rows, kMergeInts)
                      const float* __restrict__ ws,        // (slots, d)
                      float* __restrict__ out,             // (num_nodes, d)
                      int num_merges, int d) {
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const int64_t m = (int64_t)blockIdx.x * kWarps + warp;
  const int c = (blockIdx.y * 32 + lane_id) * kVec;
  if (m >= num_merges || c >= d) return;
  const int* mg = merges + m * kMergeInts;
  float* o = out + (int64_t)mg[kMRow] * d + c;
  const float* p = ws + (int64_t)mg[kMSlot] * d + c;
  const int parts = mg[kMCount] - 1;
  float v[kVec];
  load_cols<kVec>(o, v);
  for (int k0 = 0; k0 < parts; k0 += kBatch) {
    float part[kBatch][kVec];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k0 + k < parts) load_cols<kVec>(p + (int64_t)(k0 + k) * d, part[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k0 + k < parts) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] += part[k][j];
      }
    }
  }
  store_cols<kVec>(o, v);
}

template <int kVec, int kUnroll>
cudaError_t launch_rows(const void* items, const void* src, const void* lane, const void* vals,
                        const void* feat, void* out, void* ws, int num_items, int d, int tpe,
                        cudaStream_t stream) {
  const dim3 grid((num_items + kWarps - 1) / kWarps, (d + tpe * kVec - 1) / (tpe * kVec));
  spmm_ell_rows_kernel<kVec, kUnroll><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(items), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(lane), static_cast<const float*>(vals),
      static_cast<const float*>(feat), static_cast<float*>(out), static_cast<float*>(ws),
      num_items, d, tpe);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K6 (the row walk, then the merge of cut rows) on `stream` and
// returns the first CUDA error as an int (0 on success;
// cudaErrorInvalidValue for a geometry it does not take). `items`, `src`,
// `lane` and `merges` are the row order of ops/ell.py:ell_row_order; `ws`
// holds `slots` rows of d floats (null when no row is cut). vec is 4 (d %
// 4 == 0 and feat 16-byte aligned) or 1; tpe (threads an edge, a power of
// two up to 32) and unroll (1, 2 or 4) as ops/ell.py:_k6_lanes picks them.
int voltrix_spmm_ell_f32(const void* items, const void* src, const void* lane,
                         const void* vals, const void* merges, const void* feat, void* out,
                         void* ws, int num_items, int num_merges, int d, int vec, int tpe,
                         int unroll, void* stream) {
  if (num_items <= 0 || d <= 0 || (vec != 1 && vec != 4) || tpe <= 0 || tpe > 32 ||
      (tpe & (tpe - 1)) != 0 || (unroll != 1 && unroll != 2 && unroll != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec == 4) {
    err = unroll == 4   ? launch_rows<4, 4>(items, src, lane, vals, feat, out, ws, num_items, d, tpe, s)
          : unroll == 2 ? launch_rows<4, 2>(items, src, lane, vals, feat, out, ws, num_items, d, tpe, s)
                        : launch_rows<4, 1>(items, src, lane, vals, feat, out, ws, num_items, d, tpe, s);
  } else {
    err = unroll == 4   ? launch_rows<1, 4>(items, src, lane, vals, feat, out, ws, num_items, d, tpe, s)
          : unroll == 2 ? launch_rows<1, 2>(items, src, lane, vals, feat, out, ws, num_items, d, tpe, s)
                        : launch_rows<1, 1>(items, src, lane, vals, feat, out, ws, num_items, d, tpe, s);
  }
  if (err != cudaSuccess || num_merges == 0) return static_cast<int>(err);
  const dim3 grid((num_merges + kWarps - 1) / kWarps, (d + 32 * vec - 1) / (32 * vec));
  if (vec == 4) {
    spmm_ell_merge_kernel<4><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(merges), static_cast<const float*>(ws),
        static_cast<float*>(out), num_merges, d);
  } else {
    spmm_ell_merge_kernel<1><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(merges), static_cast<const float*>(ws),
        static_cast<float*>(out), num_merges, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

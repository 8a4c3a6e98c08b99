// Kernel K3: the coverage-fused SpMM, out[num_nodes, d] = A @ feat, over a
// coverage plan (gather_segment = seg >= 8), for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/pallas_spmm_fused.py:_fused_kernel, the TPU
// translation of the reference's producer/consumer kernel: X arrives in runs
// of seg consecutive source rows, one bulk copy per run, pipelined a few
// groups deep while the current group accumulates. Here the copies are
// cp.async into a ring of shared-memory slots.
//
// Design. One thread block of 16 warps per (window w, slab of 16 32-row
// words = 512 rows, 32-column feature chunk). Warp g owns word 16*slab + g:
// lane l owns column chunk*32 + l of that word's 32 rows, whose fp32 sums
// live in the warp's own slice of shared memory (only lane l touches
// column l, so no synchronisation). The window's blocks are walked as tiles
// of 128 lanes. All 512 threads stage tile t into slot t % kSlots of shared
// memory: row r of the tile is lane lane0 + r of its block, and its X row is
// the run head hind[b, (lane / seg) * seg] plus lane % seg (the packed
// descriptors of pallas_spmm_fused.py:247-252, read in place from hind, so
// no descriptor array is built). Each warp copies whole 128-byte row
// slices, so the loads are coalesced; a row past the last source row, or a
// column past d, is zero-filled by the copy (src-size 0), so the tail run of
// the plan needs no padded copy of X. kSlots - 1 tiles are in flight while
// one accumulates. For a tile, each warp loads its word of the tile's 128
// lanes (the next tile's words are loaded ahead), walks the lanes whose word
// has a bit (ballot, __ffs, the word broadcast by a shuffle), and for each
// set bit adds X[lane, col] from shared memory into that row's sum. Every
// row has one owning warp and sums in a fixed order, so the result is
// deterministic. A window with no blocks writes zeros.
//
// Bound. Each X run is staged once per 512-row slab and column chunk: at
// block_h 2048 a run is read 4 times per column chunk (the X re-read factor;
// per 32-row word, as K1 does, it would be 64). The copies of the 4 slabs and
// of all column chunks of a window run side by side (the slab is the fastest
// grid index), so the repeats are served from L2. The walk then bounds the
// kernel: a few instructions per (lane, word) with a bit and per set bit,
// with short dependent chains through shared memory. On the protein proxy
// (fill 0.45%, ~1.1 bits per such pair) this walk took half the time of
// K1's register sums with a byte-skipping bit loop.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;  // 32-row words per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileLanes = 128;  // lanes of a block staged at once
constexpr int kSlots = 8;        // shared-memory ring of staged tiles
constexpr int kTileFloats = kTileLanes * 32;
constexpr int kSumFloats = 32 * 32;  // a warp's 32 rows x 32 columns of sums
constexpr int kSmemBytes = (kSlots * kTileFloats + kWarps * kSumFloats) * sizeof(float);

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst_s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads)
spmm_fused_kernel(const uint32_t* __restrict__ bitmask,   // (B, words, block_w)
                  const int32_t* __restrict__ hind,       // (B, block_w)
                  const int32_t* __restrict__ block_ptr,  // (num_windows + 1)
                  const float* __restrict__ feat,         // (source_rows, d)
                  float* __restrict__ out,                // (num_nodes, d)
                  int words, int slabs, int block_h, int block_w, int seg,
                  int num_nodes, int source_rows, int d) {
  // (kSlots, kTileLanes, 32) staged X, then (kWarps, 32, 32) sums
  extern __shared__ float s_mem[];

  const int w = blockIdx.x / slabs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wi = (blockIdx.x % slabs) * kWarps + warp;
  const bool word_ok = wi < words;
  const int col = blockIdx.y * 32 + lane;
  const bool col_ok = col < d;

  // row s of this warp's word, column lane: only this lane touches it
  float* acc = s_mem + kSlots * kTileFloats + warp * kSumFloats + lane;
#pragma unroll
  for (int s = 0; s < 32; ++s) acc[32 * s] = 0.f;

  const int tiles_per_block = block_w / kTileLanes;
  const int b_begin = block_ptr[w];
  const int tiles = (block_ptr[w + 1] - b_begin) * tiles_per_block;

  // producer: copy tile t's 128 X rows (32 columns each) into its slot
  auto stage = [&](int t) {
    if (t < tiles) {
      const int64_t b = b_begin + t / tiles_per_block;
      const int lane0 = (t % tiles_per_block) * kTileLanes;
      float* dst = s_mem + (t % kSlots) * kTileFloats;
#pragma unroll
      for (int r = warp; r < kTileLanes; r += kWarps) {
        const int l = lane0 + r;
        const int64_t row = (int64_t)hind[b * block_w + (l / seg) * seg] + l % seg;
        const bool ok = col_ok && row < source_rows;
        cp_async4(dst + r * 32 + lane, ok ? feat + row * d + col : feat, ok);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  // this warp's bitmask word for the 4 32-lane slices of tile t
  auto load_words = [&](int t, uint32_t (&m)[4]) {
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) m[sl] = 0u;
    if (word_ok && t < tiles) {
      const int64_t b = b_begin + t / tiles_per_block;
      const int lane0 = (t % tiles_per_block) * kTileLanes;
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        m[sl] = bitmask[(b * words + wi) * block_w + lane0 + sl * 32 + lane];
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kSlots - 1; ++t) stage(t);
  uint32_t cur[4], nxt[4];
  load_words(0, cur);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kSlots - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and every warp is done with tile t - 1
    stage(t + kSlots - 1);  // into tile t - 1's slot
    load_words(t + 1, nxt);
    const float* xs = s_mem + (t % kSlots) * kTileFloats + lane;
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      // walk the lanes whose word has a bit, then that word's set bits;
      // both loops are uniform across the warp
      unsigned kept = __ballot_sync(0xffffffffu, cur[sl] != 0u);
      while (kept) {
        const int src = __ffs(kept) - 1;
        kept &= kept - 1;
        uint32_t m = __shfl_sync(0xffffffffu, cur[sl], src);
        const float x = xs[(sl * 32 + src) * 32];
        while (m) {
          acc[32 * (__ffs(m) - 1)] += x;
          m &= m - 1;
        }
      }
    }
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) cur[sl] = nxt[sl];
  }
  cp_async_wait<0>();

  if (!word_ok || !col_ok) return;
  const int64_t row0 = (int64_t)w * block_h + 32 * wi;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    if (row0 + s < num_nodes) out[(row0 + s) * d + col] = acc[32 * s];
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream` and returns the first CUDA error as an int (0 on
// success). All pointers are device pointers; `bitmask` holds uint32 words.
// block_w is a multiple of 128 and block_h of 32; seg >= 8 divides block_w.
int voltrix_spmm_fused_f32(const void* bitmask, const void* hind,
                           const void* block_ptr, const void* feat, void* out,
                           int num_windows, int words, int block_h, int block_w,
                           int seg, int num_nodes, int source_rows, int d,
                           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spmm_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slabs = (words + kWarps - 1) / kWarps;
  const dim3 grid(num_windows * slabs, (d + 31) / 32);
  spmm_fused_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmask), static_cast<const int32_t*>(hind),
      static_cast<const int32_t*>(block_ptr), static_cast<const float*>(feat),
      static_cast<float*>(out), words, slabs, block_h, block_w, seg, num_nodes,
      source_rows, d);
  return static_cast<int>(cudaGetLastError());
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

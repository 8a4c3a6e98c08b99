// Kernel K2: the sub-window-skipping SpMM, out[num_nodes, d] = A @ feat, over
// the binned block-CSR plan with a per-block occupancy bitmap, for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_subtiled_kernel together
// with the row gather it consumes there. The TPU kernel expands and multiplies
// only the 128-row sub-windows whose occupancy bit is set, ORed over each
// unroll group so its MXU dots stay wide. Here the skip is per block: bit
// s of occ[b] is set iff sub-window s of block b holds a bit (format/cluster.py
// block_occupancy, or the wrapper computes it from the bitmask), so a block
// whose bit is clear carries no bits in those rows, and skipping it gives the
// same sums as the group skip, with fewer blocks visited.
//
// Design: the walk of csrc/spmm_walk.cuh with the occupancy test. A
// sub-window is one 128-row group of the walk. The wrapper cuts each
// (window, sub-window) into pieces that hold at most
// PIECE_BLOCKS["spmm_subtile"] = 64 blocks with the sub-window's bit and
// about PIECE_WORK["spmm_subtile"] = 1024 units of work (from
// tools/spmm_piece_sweep.py), so a thread block only gets blocks it walks,
// and a sub-window without any one empty task that writes its zeros;
// inside a piece's block range, warp 0 lists the blocks with the bit (a
// ballot over occ) and the four warps walk only those. Resources as K1's
// (csrc/spmm_block.cu): 162 registers (168 with 4-byte copies), no spills,
// 34,816 + 1,040 bytes of shared memory, three thread blocks an SM.
//
// Bound. Bytes: the kept (lane, word) pairs' X slices, the bitmask words of
// occupied sub-windows, hind, occ and out; each input read once, 0.108 /
// 0.160 ms at d 128 / 256 on the ogbn-arxiv proxy at PlanConfig(2048, 128,
// block_unroll=4, cluster_cols=True). On an NVIDIA H100 80GB HBM3 at 700 W
// this kernel takes 0.463 / 0.870 ms there, torch.sparse.mm 0.261 / 0.487.
// The earlier design (one thread block per window, 32-row word and 32
// columns) took 2.444 / 3.577 ms: the first window holds 1,100 of 5,696
// blocks, and the thread block of its first word walked 4,400 units
// against a mean of 274.
//
// No tensor cores: the plan fills 0.13% of its 2048 x 128 block slots, and
// K2 is held to float32 parity.
//
// bf16 features (voltrix_spmm_subtile_bf16; pallas_spmm.py:263 casts the
// gathered tile in the kernel): the walk's kBF16 source, as K1's
// (csrc/spmm_block.cu), bit for bit the float32 kernel on the widened rows;
// float16 features (voltrix_spmm_subtile_f16) likewise on its kF16 source.

#include "spmm_walk.cuh"

extern "C" {

// Launches K2 (the walk, then the merge of cut groups) on `stream` and
// returns the first CUDA error as an int (0 on success). All pointers are
// device pointers; `bitmask` and `occ` hold uint32 words; `tasks`,
// `merges` and `ws` as for K1 (spmm_walk.cuh). block_h is a multiple of
// 128.
int voltrix_spmm_subtile_f32(const void* bitmask, const void* hind, const void* occ,
                             const void* tasks, const void* merges, const void* feat, void* out,
                             void* ws, int num_tasks, int num_merges, int words, int block_h,
                             int block_w, int num_nodes, int source_rows, int d, int vec,
                             void* stream) {
  namespace vw = voltrix_walk;
  auto walk = vec ? vw::launch_walk<true, vw::kF32x4> : vw::launch_walk<true, vw::kF32x1>;
  return walk(bitmask, hind, occ, tasks, merges, feat, nullptr, out, ws, num_tasks, num_merges,
              words, block_h, block_w, num_nodes, source_rows, d, d, stream);
}

// K2 on bf16 rows of width ld (a multiple of 4, >= d; feat 8-byte aligned),
// as voltrix_spmm_block_bf16.
int voltrix_spmm_subtile_bf16(const void* bitmask, const void* hind, const void* occ,
                              const void* tasks, const void* merges, const void* feat, void* out,
                              void* ws, int num_tasks, int num_merges, int words, int block_h,
                              int block_w, int num_nodes, int source_rows, int d, int ld,
                              void* stream) {
  if (ld % 4 != 0 || ld < d) return static_cast<int>(cudaErrorInvalidValue);
  return voltrix_walk::launch_walk<true, voltrix_walk::kBF16>(
      bitmask, hind, occ, tasks, merges, feat, nullptr, out, ws, num_tasks, num_merges, words,
      block_h, block_w, num_nodes, source_rows, d, ld, stream);
}

// K2 on float16 rows of width ld, as voltrix_spmm_subtile_bf16.
int voltrix_spmm_subtile_f16(const void* bitmask, const void* hind, const void* occ,
                             const void* tasks, const void* merges, const void* feat, void* out,
                             void* ws, int num_tasks, int num_merges, int words, int block_h,
                             int block_w, int num_nodes, int source_rows, int d, int ld,
                             void* stream) {
  if (ld % 4 != 0 || ld < d) return static_cast<int>(cudaErrorInvalidValue);
  return voltrix_walk::launch_walk<true, voltrix_walk::kF16>(
      bitmask, hind, occ, tasks, merges, feat, nullptr, out, ws, num_tasks, num_merges, words,
      block_h, block_w, num_nodes, source_rows, d, ld, stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

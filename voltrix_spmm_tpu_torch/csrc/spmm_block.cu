// Kernel K1: the block SpMM, out[num_nodes, d] = A @ feat, over the binned
// block-CSR plan of voltrix_spmm_tpu_torch/format/plan.py, for sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_block_kernel together
// with the row gather it consumes there (_gather_rows, a jnp.take). The TPU
// kernel walks a sequential grid and revisits a window's output tile while
// the window is unchanged; blocks on Hopper run in parallel and in no
// order, so here a window's blocks are cut into pieces that thread blocks
// on many SMs walk side by side, and the pieces' tiles are summed in piece
// order. The gather is fused: no (total_blocks * block_w, d) array is
// materialised.
//
// Design: the walk of csrc/spmm_walk.cuh without the occupancy test. One
// thread block of four warps per (piece, 128-row group, 128 columns); a
// piece holds at most PIECE_BLOCKS["spmm_block"] = 32 blocks and about
// PIECE_WORK["spmm_block"] = 2048 units of work (ops/block_spmm.py; from
// tools/spmm_piece_sweep.py), so the hub window of a power-law graph
// spreads over many SMs. A warp owns a 32-row word, keeps its sums in
// registers and gathers its kept lanes' X slices, 16 bytes a lane, through
// a cp.async ring 15 slices deep; the pieces of a cut group are summed in
// piece order by the merge kernel. A window with no blocks writes zeros.
// Lanes whose hind lies past the last source row (the tail of
// gather_segment > 1 plans) carry no bits and are skipped.
//
// Resources (nvcc -Xptxas -v, sm_90a): the walk 162 registers a thread
// (168 with 4-byte copies), no spills, 34,816 bytes of dynamic and 1,040
// of static shared memory a thread block of 128 threads, three thread
// blocks an SM; the merge 40 to 50 registers, no shared memory.
//
// Bound. Bytes: each kept (lane, word) pair's X slice (d floats), the
// bitmask, hind and out. On the ogbn-arxiv proxy at PlanConfig(128, 128)
// the 1.41M kept pairs need 722 MB of X slices at d 128, 0.22 ms at 3.35
// TB/s if none hit the 50 MB L2; the plan's own bound (each input read
// once) is 0.059 / 0.111 ms at d 128 / 256. On an NVIDIA H100 80GB HBM3 at
// 700 W this kernel takes 0.381 / 0.697 ms there, torch.sparse.mm 0.256 /
// 0.480. The earlier design (one thread block per window, 32-row word and
// 32 columns, 4-byte loads, 8 in flight a warp) took 2.129 / 3.039 ms, set
// by the one thread block that walked the hub window's first word (97,871
// kept pairs). The hub window's first blocks are dense (hub rows against
// hub columns: many bits a kept pair), so a piece's time follows its bits
// as much as its pairs: the sums live in registers, and a piece ends at a
// work limit as well as a block count.
//
// No tensor cores: the plan fills 1.19% of its 128 x 128 block slots, so a
// dense tile product does ~80x the useful work, and K1 is held to float32
// parity (no tf32; a three-pass bf16 split of X would do ~250x).

#include "spmm_walk.cuh"

extern "C" {

// Launches K1 (the walk, then the merge of cut groups) on `stream` and
// returns cudaGetLastError() as an int (0 on success). All pointers are
// device pointers; `bitmask` holds uint32 words; `tasks`, `merges` and
// `ws` are described in spmm_walk.cuh (ws may be null when no group is
// cut). vec = 1 iff d % 4 == 0 and feat is 16-byte aligned.
int voltrix_spmm_block_f32(const void* bitmask, const void* hind, const void* tasks,
                           const void* merges, const void* feat, void* out, void* ws,
                           int num_tasks, int num_merges, int words, int block_h, int block_w,
                           int num_nodes, int source_rows, int d, int vec, void* stream) {
  namespace vw = voltrix_walk;
  auto walk = vec ? vw::launch_walk<false, vw::kF32x4> : vw::launch_walk<false, vw::kF32x1>;
  return walk(bitmask, hind, nullptr, tasks, merges, feat, nullptr, out, ws, num_tasks, num_merges,
              words, block_h, block_w, num_nodes, source_rows, d, d, stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

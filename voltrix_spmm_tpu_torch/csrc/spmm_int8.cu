// Kernel K8: the int8 SpMM, out[num_nodes, d] = A @ dequant(q, scale), over
// the binned block-CSR plan of voltrix_spmm_tpu_torch/format/plan.py, for
// sm_90a.
//
// Replaces voltrix_spmm_tpu/ops/quant.py:_quant_kernel together with the two
// gathers it consumes there (the int8 rows and the per-row scales, each a
// jnp.take). The features arrive quantized per source row: q int8 (source_rows,
// d4) with d4 = d rounded up to a multiple of 4 (zero columns), and one
// float32 scale per row. The TPU kernel's arithmetic is kept exactly: each
// gathered value is bf16_rn(float(q) * float(bf16_rn(scale[src]))) (q is exact
// in bf16, and a product of two bf16 values is exact in float32, so the one
// rounding is the bf16 multiply's), and the sums are float32. bf16 rows
// are quantized in bf16 (ops/quant.py, as jnp does): their scales are bf16
// values, which bf16_rn leaves as they are, so the same kernel reads their
// codes.
//
// Design: the walk of csrc/spmm_walk.cuh that K1 runs, on int8 rows (kI8).
// One thread block of four warps per (piece, 128-row group, 128 columns); a
// piece holds at most PIECE_BLOCKS["spmm_int8"] blocks and about
// PIECE_WORK["spmm_int8"] units of work (ops/block_spmm.py, from
// tools/spmm_piece_sweep.py), so the hub window of a power-law graph and the
// 64-word windows of a block_h 2048 plan spread over many SMs. A warp owns a
// 32-row word and keeps its sums in registers; lane l copies the 4 bytes of
// its four int8 columns of each kept lane's row through a cp.async ring 31
// slices deep (128 bytes a slice), and the row's scale comes through the
// warp's queue with its hind. The gather and the dequantization are fused:
// no gathered or dequantized array is materialised. The pieces of a cut
// group are summed in piece order by the walk's merge kernel, so two
// launches give the same bits. A window with no blocks writes zeros; lanes
// whose hind lies past the last source row (the tail of gather_segment > 1
// plans) are skipped.
//
// Resources (nvcc -Xptxas -v, sm_90a): the int8 walk 167 registers a
// thread, no spills, 19,456 bytes of dynamic and 1,040 of static shared
// memory a thread block of 128 threads, three thread blocks an SM (the
// walk's launch bound); the merge 40 to 50 registers.
//
// Bound. Bytes: the bitmask, hind, the int8 rows and scales, and out, each
// once. Each kept (lane, word) pair moves d4 bytes of q instead of K1's 4 d,
// so the walk, not the gathers, sets the time: the instructions a warp
// spends on each kept pair (the queue, the copy, the dequantization of its
// four values, the set bits' adds), one pair after another. On an NVIDIA
// H100 80GB HBM3 at 700 W K8 takes 0.535 / 0.983 ms at d 128 / 256 on the
// ogbn-arxiv proxy's PlanConfig(128, 128) plan (K1 0.384 / 0.706 in turns;
// torch.sparse.mm on the dequantized rows 0.255 / 0.484; bound 0.040 /
// 0.072), and 45.36 ms at d 256 on the protein proxy's PlanConfig(2048,
// 128, gather_segment=128, block_unroll=4) plan, 31,827 pieces and a 3.8
// GiB workspace (K3 70.5, torch.sparse.mm 16.9, bound 0.72).

#include "spmm_walk.cuh"

extern "C" {

// Launches K8 (the walk, then the merge of cut groups) on `stream` and
// returns the first CUDA error as an int (0 on success). All pointers are
// device pointers; `bitmask` holds uint32 words; `q` int8 rows of d4 (a
// multiple of 4) bytes, 4-byte aligned, `scale` one float32 per row;
// `tasks`, `merges` and `ws` as for K1 (spmm_walk.cuh; ws may be null when
// no group is cut).
int voltrix_spmm_int8(const void* bitmask, const void* hind, const void* tasks,
                      const void* merges, const void* q, const void* scale, void* out, void* ws,
                      int num_tasks, int num_merges, int words, int block_h, int block_w,
                      int num_nodes, int source_rows, int d, int d4, void* stream) {
  if (d4 % 4 != 0 || d4 < d) return static_cast<int>(cudaErrorInvalidValue);
  return voltrix_walk::launch_walk<false, voltrix_walk::kI8>(
      bitmask, hind, nullptr, tasks, merges, q, scale, out, ws, num_tasks, num_merges, words,
      block_h, block_w, num_nodes, source_rows, d, d4, stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

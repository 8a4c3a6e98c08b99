// Kernels K9 and K13 under compute_dtype=float16, for sm_90a: the
// instantiation of attn_fwd_half.cuh (its comment holds the design) for
// compute type __half.

#include <cuda_fp16.h>

#include "attn_fwd_half.cuh"

extern "C" {

// Launches K13 at compute_dtype=float16 on `stream` (K9: heads = 1, float32
// planes): pass 1 over `tasks` for every head group, pass 2 likewise, and,
// when a group of rows is cut, the merge of each head's shares; returns
// cudaGetLastError() as an int (0 on success; cudaErrorInvalidValue for a
// geometry it does not take). The arguments are voltrix_attn_mh_fwd's
// (csrc/attn_fwd.cu), with the plan's window_of_block (int32 a block), its
// block_unroll (the TPU kernel's grid step) and total blocks, and bmax, a
// (heads, blocks, block_h) float32 workspace; bf16: the planes k and v hold
// bf16 values, else float32. hg heads share a thread block's walk and acc
// columns of v a lane's registers: the pairs of csrc/attn_fwd.cu's
// dispatch_mh. Every row of `out` and `lse` is written.
int voltrix_attn_fwd_f16(const void* bitmask, const void* hind, const void* window_of_block,
                         const void* tasks, const void* merges, const void* q, const void* k,
                         const void* v, void* bmax, void* out, void* lse, void* ws_ml,
                         void* ws_acc, int num_tasks, int num_merges, int heads, int hg,
                         int words, int block_h, int block_w, int unroll, int num_blocks,
                         int nq, int nk, int dk, int dv, int padded, int acc, int bf16,
                         float scale, float slope, int vec_k, int vec_v, long long q_head,
                         long long q_row, long long k_head, long long k_row, long long v_head,
                         long long v_row, void* stream) {
  return fwd_half<__half>(bitmask, hind, window_of_block, tasks, merges, q, k, v, bmax,
      out, lse, ws_ml, ws_acc, num_tasks, num_merges, heads, hg, words, block_h, block_w, unroll,
      num_blocks, nq, nk, dk, dv, padded, acc, bf16, scale, slope, vec_k, vec_v, q_head, q_row,
      k_head, k_row, v_head, v_row, stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

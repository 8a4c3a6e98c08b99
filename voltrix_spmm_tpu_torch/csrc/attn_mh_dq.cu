// Kernel K14: the dQ half of the multi-head fused attention's backward,
// for sm_90a, over the plan of A. For head h, destination row r and its
// in-neighbours l:
//
//   raw = q[h, r] . k[h, l],  p = exp(leaky_relu(scale * raw) - lse[h, r])
//   ds  = p * (dO[h, r] . v[h, l] - D[h, r]) * (raw > 0 ? 1 : slope) * scale
//   dq[h, r] = sum_l ds * k[h, l]
//
// with lse from the forward (K13) and D = rowsum(dO o out).
//
// Replaces voltrix_spmm_tpu/ops/attention_mh.py:_attn_bwd_dq_mh_kernel
// together with its [k || v] gather and the [q || dO] pair plane. The TPU
// forms the (block_h, U*K) score, p and dP tiles on the MXU per step and
// multiplies ds by the gathered [k || v] block, slicing the pollution of
// the v zone off on the host. Here q and dO (float) and k and v (float, or
// bf16 for the bf16 plane) are read as (H, n, d) tensors, gathered by hind
// inside the kernel; lse and D come from their own float arrays.
//
// Design (see attn_mh_common.cuh for the task split and the edge walks).
// One thread block per (task, group of up to 8 heads, chunk of dc <= 128
// columns of dq). lse is known, so one pass suffices: each edge computes
// raw, p, dP and ds for each head of the group in registers and stores ds
// in row order (for_each_edge_batch); a thread per (head, row, four
// columns) then adds sum ds * k into a (heads x block_h x dc) tile. A window
// wholly inside the task is stored; a window cut over several tasks is
// added to the zeroed dq with global atomicAdd, whose order changes from
// run to run.
//
// Bound. Per edge and head 4 * dk + 2 * dv flops and an exp; the bytes are
// the plan, q, k, v, dO, lse, D and dq once each. The per-edge gathers of
// k and v rows (L2 hits on the arxiv proxy) separate the kernel from it.

#include "attn_mh_common.cuh"

namespace {

using namespace voltrix_attn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_mh_dq_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                  const int32_t* __restrict__ hind,      // (B, K)
                  const int32_t* __restrict__ wob,       // (B,)
                  const int32_t* __restrict__ block_ptr, // (W + 1,)
                  const float* __restrict__ q,           // (H, nq, dk)
                  const T* __restrict__ k,               // (H, nk, dk)
                  const T* __restrict__ v,               // (H, nk, dv)
                  const float* __restrict__ g,           // dO, (H, nq, dv)
                  const float* __restrict__ lse,         // (H, lse_stride)
                  const float* __restrict__ drow,        // D, (H, nq)
                  float* __restrict__ dq,                // (H, nq, dk), zeroed
                  int total_blocks, int words, int block_h, int block_w, int heads,
                  int head_group, int nq, int nk, int lse_stride, int dk, int dv, int dc,
                  int task_blocks, float scale, float slope, int vec_k, int vec_v) {
  extern __shared__ float smem[];
  __shared__ int s_scan[kScanInts];
  const int h0 = blockIdx.y * head_group;
  const int hg = min(head_group, heads - h0);  // this block's heads
  const int stride = dc | 1;
  float* s_acc = smem;                                  // (hg, block_h, stride)
  float* s_ds = s_acc + (int64_t)hg * block_h * stride;  // (hg, kBatch), in row order
  int* s_cnt = reinterpret_cast<int*>(s_ds + hg * kBatch);  // (block_h,)
  int* s_off = s_cnt + block_h;                             // (block_h + 1,)
  int* s_esrc = s_off + block_h + 1;                        // (kBatch,)
  const int c0 = blockIdx.z * dc;
  const int cw = min(dc, dk - c0);
  // four columns at a time: whole groups of 4 in a row 16-byte (or 8-byte) aligned
  const bool vec_sum = vec_k && dc % 4 == 0 && cw % 4 == 0;
  const int groups = vec_sum ? cw / 4 : cw;

  for (int i = threadIdx.x; i < hg * block_h * stride; i += blockDim.x) s_acc[i] = 0.f;
  for (int i = threadIdx.x; i < block_h; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();

  const int b_lo = blockIdx.x * task_blocks;
  const int b_hi = min(total_blocks, b_lo + task_blocks);
  for (int b = b_lo; b < b_hi;) {
    const int w = __ldg(&wob[b]);
    const int w_lo = __ldg(&block_ptr[w]);
    const int w_hi = __ldg(&block_ptr[w + 1]);
    const int e = min(b_hi, w_hi);
    const int64_t row0 = (int64_t)w * block_h;
    const int rows = window_rows(row0, block_h, nq);
    for_each_edge_batch(
        bitmask, hind, b, e, words, block_w, rows, nk, s_scan, s_cnt, s_off, s_esrc,
        [&](int r, int src, int slot, int) {
          const int64_t row = row0 + r;
          for (int j = 0; j < hg; ++j) {
            const int h = h0 + j;
            const float raw = dot(q + ((int64_t)h * nq + row) * dk,
                                  k + ((int64_t)h * nk + src) * dk, dk, vec_k);
            const float p =
                expf(act(raw, scale, slope) - __ldg(&lse[(int64_t)h * lse_stride + row]));
            const float dp = dot(g + ((int64_t)h * nq + row) * dv,
                                 v + ((int64_t)h * nk + src) * dv, dv, vec_v);
            s_ds[j * kBatch + slot] =
                p * (dp - __ldg(&drow[(int64_t)h * nq + row])) * act_grad(raw, slope) * scale;
          }
        },
        [&](int, int, int) {
          for (int i = threadIdx.x; i < hg * rows * groups; i += blockDim.x) {
            const int j = i / (rows * groups);
            const int r = (i / groups) % rows;
            const int cg = i % groups;
            const int n = s_cnt[r], e0 = s_off[r];
            if (n == 0) continue;
            const T* kh = k + (int64_t)(h0 + j) * nk * dk + c0;
            const float* ds = s_ds + j * kBatch;
            float* tile = s_acc + ((int64_t)j * block_h + r) * stride;
            if (vec_sum) {
              float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
              for (int x = e0; x < e0 + n; ++x) {
                axpy4(ds[x], kh + (int64_t)s_esrc[x] * dk + 4 * cg, a);
              }
              tile[4 * cg] += a.x;
              tile[4 * cg + 1] += a.y;
              tile[4 * cg + 2] += a.z;
              tile[4 * cg + 3] += a.w;
            } else {
              float a = 0.f;
              for (int x = e0; x < e0 + n; ++x) {
                a = fmaf(ds[x], to_f(kh[(int64_t)s_esrc[x] * dk + cg]), a);
              }
              tile[cg] += a;
            }
          }
        });
    flush_add(s_acc, stride, block_h, hg, rows, cw, w_lo >= b_lo && w_hi <= b_hi,
              [&](int j, int r, int c) {
                return dq + ((int64_t)(h0 + j) * nq + row0 + r) * dk + c0 + c;
              });
    __syncthreads();
    b = e;
  }
}

template <typename T>
int launch(const void* bitmask, const void* hind, const void* wob, const void* block_ptr,
           const void* q, const void* k, const void* v, const void* g, const void* lse,
           const void* drow, void* dq, int total_blocks, int words, int block_h, int block_w,
           int heads, int head_group, int nq, int nk, int lse_stride, int dk, int dv, int dc,
           int task_blocks, float scale, float slope, int vec_k, int vec_v, void* stream) {
  const int hg = min(head_group, heads);
  const int64_t smem =
      ((int64_t)hg * block_h * (dc | 1) + 2 * block_h + 1 + (int64_t)(hg + 1) * kBatch) * 4;
  const dim3 grid((total_blocks + task_blocks - 1) / task_blocks,
                  (heads + head_group - 1) / head_group, (dk + dc - 1) / dc);
  return launch_kernel(
      attn_mh_dq_kernel<T>, grid, smem, stream, static_cast<const uint32_t*>(bitmask),
      static_cast<const int32_t*>(hind), static_cast<const int32_t*>(wob),
      static_cast<const int32_t*>(block_ptr), static_cast<const float*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(drow), static_cast<float*>(dq),
      total_blocks, words, block_h, block_w, heads, head_group, nq, nk, lse_stride, dk, dv, dc,
      task_blocks, scale, slope, vec_k, vec_v);
}

}  // namespace

extern "C" {

// Launches K14 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take). `dq`
// must be zero-filled. One thread block serves head_group heads (at most
// 8). k and v are bf16 when bf16 != 0, else float.
int voltrix_attn_mh_dq(const void* bitmask, const void* hind, const void* wob,
                       const void* block_ptr, const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* drow, void* dq,
                       int total_blocks, int words, int block_h, int block_w, int heads,
                       int head_group, int nq, int nk, int lse_stride, int dk, int dv, int dc,
                       int task_blocks, float scale, float slope, int vec_k, int vec_v,
                       int bf16, void* stream) {
  if (total_blocks <= 0 || words <= 0 || words * 32 < block_h || block_h <= 0 || block_w <= 0 ||
      heads <= 0 || head_group <= 0 || head_group > kMaxHeadGroup ||
      (heads + head_group - 1) / head_group > 65535 || nq <= 0 || nk <= 0 || lse_stride < nq ||
      dk <= 0 || dv < 0 || dc <= 0 || (dk + dc - 1) / dc > 65535 || task_blocks <= 0 ||
      (vec_k && dk % 4) || (vec_v && dv % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<__nv_bfloat16>(bitmask, hind, wob, block_ptr, q, k, v, g, lse, drow, dq,
                                      total_blocks, words, block_h, block_w, heads, head_group,
                                      nq, nk, lse_stride, dk, dv, dc, task_blocks, scale, slope,
                                      vec_k, vec_v, stream)
              : launch<float>(bitmask, hind, wob, block_ptr, q, k, v, g, lse, drow, dq,
                              total_blocks, words, block_h, block_w, heads, head_group, nq, nk,
                              lse_stride, dk, dv, dc, task_blocks, scale, slope, vec_k, vec_v,
                              stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Kernel K15: the dK/dV half of the multi-head fused attention's backward,
// for sm_90a, over the plan of A^T. Its windows own source rows l (rows of
// k and v); its lanes are the destination rows r that attend to them. For
// head h and each edge (r <- l):
//
//   raw = k[h, l] . q[h, r],  p = exp(leaky_relu(scale * raw) - lse[h, r])
//   ds  = p * (v[h, l] . dO[h, r] - D[h, r]) * (raw > 0 ? 1 : slope) * scale
//   dk[h, l] = sum_r ds * q[h, r],   dv[h, l] = sum_r p * dO[h, r]
//
// Replaces voltrix_spmm_tpu/ops/attention_mh.py:_attn_bwd_dkv_mh_kernel
// together with its gathered [q || dO || stats] plane. The TPU packs lse and
// D into the gathered plane (as hi/lo bf16 pairs when the plane is bf16) and
// selects each head's lane with a masked reduce. Here k, v (the window's own
// rows) and q, dO (gathered by hind) are read as (H, n, d) tensors, float or
// bf16 (the bf16 plane rounds all four, as the TPU's kvw and qdo planes do);
// lse and D are read from their own float arrays.
//
// Design (see attn_mh_common.cuh for the task split and the edge walks).
// One thread block per (task, group of up to 8 heads, chunk of dc <= 128
// columns of [dk || dv]). One pass: each edge computes raw, p, dP and ds
// for each head of the group in registers and stores p and ds in row order
// (for_each_edge_batch); a thread per (head, source row, four columns) then
// adds sum ds * q (the dk columns) or sum p * dO (the dv columns) into a
// (heads x block_h x dc) tile. A window wholly inside the task is stored;
// a window cut over several tasks is added to the zeroed outputs with
// global atomicAdd, whose order changes from run to run.
//
// Bound. Per edge and head 4 * (dk + dv) flops and an exp; the bytes are
// the transpose plan, q, k, v, dO, lse, D, dk and dv once each. The
// per-edge gathers of q and dO rows and of lse and D separate the kernel
// from it.

#include "attn_mh_common.cuh"

namespace {

using namespace voltrix_attn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_mh_dkv_kernel(const uint32_t* __restrict__ bitmask,  // plan_t (B, words, K)
                   const int32_t* __restrict__ hind,      // (B, K): destination rows
                   const int32_t* __restrict__ wob,       // (B,)
                   const int32_t* __restrict__ block_ptr, // (W + 1,)
                   const T* __restrict__ k,               // (H, nk, dk)
                   const T* __restrict__ v,               // (H, nk, dv)
                   const T* __restrict__ q,               // (H, nq, dk)
                   const T* __restrict__ g,               // dO, (H, nq, dv)
                   const float* __restrict__ lse,         // (H, lse_stride)
                   const float* __restrict__ drow,        // D, (H, nq)
                   float* __restrict__ dk_out,            // (H, nk, dk), zeroed
                   float* __restrict__ dv_out,            // (H, nk, dv), zeroed
                   int total_blocks, int words, int block_h, int block_w, int heads,
                   int head_group, int nk, int nq, int lse_stride, int dk, int dv, int dc,
                   int task_blocks, float scale, float slope, int vec_k, int vec_v) {
  extern __shared__ float smem[];
  __shared__ int s_scan[kScanInts];
  const int h0 = blockIdx.y * head_group;
  const int hg = min(head_group, heads - h0);  // this block's heads
  const int stride = dc | 1;
  float* s_acc = smem;                                 // (hg, block_h, stride)
  float* s_p = s_acc + (int64_t)hg * block_h * stride;  // (hg, kBatch), in row order
  float* s_ds = s_p + hg * kBatch;                      // (hg, kBatch)
  int* s_cnt = reinterpret_cast<int*>(s_ds + hg * kBatch);  // (block_h,)
  int* s_off = s_cnt + block_h;                             // (block_h + 1,)
  int* s_esrc = s_off + block_h + 1;                        // (kBatch,) destination rows
  const int c0 = blockIdx.z * dc;
  const int cw = min(dc, dk + dv - c0);
  // four columns at a time: whole groups of 4 that stay on one side of dk
  const bool vec_sum = vec_k && vec_v && dc % 4 == 0 && cw % 4 == 0;
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
    const int rows = window_rows(row0, block_h, nk);
    for_each_edge_batch(
        bitmask, hind, b, e, words, block_w, rows, nq, s_scan, s_cnt, s_off, s_esrc,
        [&](int r, int dst, int slot, int) {
          const int64_t row = row0 + r;
          for (int j = 0; j < hg; ++j) {
            const int h = h0 + j;
            const float raw = dot(k + ((int64_t)h * nk + row) * dk,
                                  q + ((int64_t)h * nq + dst) * dk, dk, vec_k);
            const float p =
                expf(act(raw, scale, slope) - __ldg(&lse[(int64_t)h * lse_stride + dst]));
            const float dp = dot(v + ((int64_t)h * nk + row) * dv,
                                 g + ((int64_t)h * nq + dst) * dv, dv, vec_v);
            s_p[j * kBatch + slot] = p;
            s_ds[j * kBatch + slot] =
                p * (dp - __ldg(&drow[(int64_t)h * nq + dst])) * act_grad(raw, slope) * scale;
          }
        },
        [&](int, int, int) {
          for (int i = threadIdx.x; i < hg * rows * groups; i += blockDim.x) {
            const int j = i / (rows * groups);
            const int r = (i / groups) % rows;
            const int cg = i % groups;
            const int n = s_cnt[r], e0 = s_off[r];
            if (n == 0) continue;
            const int h = h0 + j;
            const int col = c0 + (vec_sum ? 4 * cg : cg);
            // the dk columns sum ds * q, the dv columns p * dO
            const bool kcol = col < dk;
            const float* coef = (kcol ? s_ds : s_p) + j * kBatch;
            const T* base = kcol ? q + (int64_t)h * nq * dk + col
                                 : g + (int64_t)h * nq * dv + (col - dk);
            const int ld = kcol ? dk : dv;
            float* tile = s_acc + ((int64_t)j * block_h + r) * stride + (col - c0);
            if (vec_sum) {
              float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
              for (int x = e0; x < e0 + n; ++x) axpy4(coef[x], base + (int64_t)s_esrc[x] * ld, a);
              tile[0] += a.x;
              tile[1] += a.y;
              tile[2] += a.z;
              tile[3] += a.w;
            } else {
              float a = 0.f;
              for (int x = e0; x < e0 + n; ++x) {
                a = fmaf(coef[x], to_f(base[(int64_t)s_esrc[x] * ld]), a);
              }
              tile[0] += a;
            }
          }
        });
    flush_add(s_acc, stride, block_h, hg, rows, cw, w_lo >= b_lo && w_hi <= b_hi,
              [&](int j, int r, int c) {
                const int col = c0 + c;
                const int64_t row = (int64_t)(h0 + j) * nk + row0 + r;
                return col < dk ? dk_out + row * dk + col : dv_out + row * dv + (col - dk);
              });
    __syncthreads();
    b = e;
  }
}

template <typename T>
int launch(const void* bitmask, const void* hind, const void* wob, const void* block_ptr,
           const void* k, const void* v, const void* q, const void* g, const void* lse,
           const void* drow, void* dk_out, void* dv_out, int total_blocks, int words,
           int block_h, int block_w, int heads, int head_group, int nk, int nq, int lse_stride,
           int dk, int dv, int dc, int task_blocks, float scale, float slope, int vec_k,
           int vec_v, void* stream) {
  const int hg = min(head_group, heads);
  const int64_t smem =
      ((int64_t)hg * block_h * (dc | 1) + 2 * block_h + 1 + (int64_t)(2 * hg + 1) * kBatch) * 4;
  const dim3 grid((total_blocks + task_blocks - 1) / task_blocks,
                  (heads + head_group - 1) / head_group, (dk + dv + dc - 1) / dc);
  return launch_kernel(
      attn_mh_dkv_kernel<T>, grid, smem, stream, static_cast<const uint32_t*>(bitmask),
      static_cast<const int32_t*>(hind), static_cast<const int32_t*>(wob),
      static_cast<const int32_t*>(block_ptr), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(q), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<float*>(dk_out), static_cast<float*>(dv_out), total_blocks, words, block_h,
      block_w, heads, head_group, nk, nq, lse_stride, dk, dv, dc, task_blocks, scale, slope,
      vec_k, vec_v);
}

}  // namespace

extern "C" {

// Launches K15 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take). `dk_out`
// and `dv_out` must be zero-filled. One thread block serves head_group
// heads (at most 8). k, v, q and dO are bf16 when bf16 != 0, else float.
int voltrix_attn_mh_dkv(const void* bitmask, const void* hind, const void* wob,
                        const void* block_ptr, const void* k, const void* v, const void* q,
                        const void* g, const void* lse, const void* drow, void* dk_out,
                        void* dv_out, int total_blocks, int words, int block_h, int block_w,
                        int heads, int head_group, int nk, int nq, int lse_stride, int dk, int dv,
                        int dc, int task_blocks, float scale, float slope, int vec_k, int vec_v,
                        int bf16, void* stream) {
  if (total_blocks <= 0 || words <= 0 || words * 32 < block_h || block_h <= 0 || block_w <= 0 ||
      heads <= 0 || head_group <= 0 || head_group > kMaxHeadGroup ||
      (heads + head_group - 1) / head_group > 65535 || nk <= 0 || nq <= 0 ||
      lse_stride < nq || dk < 0 || dv < 0 || dk + dv <= 0 || dc <= 0 ||
      (dk + dv + dc - 1) / dc > 65535 || task_blocks <= 0 || (vec_k && dk % 4) ||
      (vec_v && dv % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<__nv_bfloat16>(bitmask, hind, wob, block_ptr, k, v, q, g, lse, drow,
                                      dk_out, dv_out, total_blocks, words, block_h, block_w,
                                      heads, head_group, nk, nq, lse_stride, dk, dv, dc,
                                      task_blocks, scale, slope, vec_k, vec_v, stream)
              : launch<float>(bitmask, hind, wob, block_ptr, k, v, q, g, lse, drow, dk_out,
                              dv_out, total_blocks, words, block_h, block_w, heads, head_group,
                              nk, nq, lse_stride, dk, dv, dc, task_blocks, scale, slope, vec_k,
                              vec_v, stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

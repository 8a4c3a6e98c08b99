// Kernel K10: the self-contained backward of the single-head fused
// attention, for sm_90a, over the plan of A alone. For destination row r
// and its in-neighbours l (lane (b, j) of the plan, hind[b, j] = l):
//
//   raw = q[r] . k[l],  p = exp(leaky_relu(scale * raw) - lse[r])
//   ds  = p * (dO[r] . v[l] - D[r]) * (raw > 0 ? 1 : slope) * scale
//   dq[r] = sum_l ds * k[l]                     (over the row's edges)
//   dk_lane[b, j] = sum_r ds * q[r],  dv_lane[b, j] = sum_r p * dO[r]
//                                               (over the lane's bits)
//
// with lse from the forward (K9) and D = rowsum(dO o out). The caller sums
// the lane planes into source rows by hind (ops/attention.py:scatter_lanes,
// the JAX package's segment_sum).
//
// Replaces voltrix_spmm_tpu/ops/attention.py:_attn_bwd_kernel together with
// its [k || v] gather. The TPU forms the (block_h, U*K) p and ds tiles on
// the MXU per grid step, accumulates dq into the window's revisited output
// block and writes the (U*K, d) lane planes as two transposed products.
// Here q, dO (the window's rows) and k, v (gathered by hind) are read as
// float (n, d) matrices inside the kernel.
//
// Design (see attn_mh_common.cuh for the task split and the edge walk).
// One thread block per (task of task_blocks plan blocks, chunk of dc <=
// 128 columns of [dq / dk_lane || dv_lane]). The walk K13-K15 share
// (for_each_edge_batch) deals a chunk of lanes' edges out in batches of up
// to kBatch; each edge computes raw, p, dP and ds in registers and keeps
// them twice in shared memory:
// - in row order (the walk's slot, as K14 keeps ds): a thread per (row,
//   four columns) adds sum ds * k into a (block_h x dc) dq tile with plain
//   adds; the tile goes to dq when the window's run ends, stored when the
//   task holds the whole window, else added with global atomicAdd (order
//   changes from run to run);
// - in edge order (the walk's place in the batch), which is lane order,
//   since the scan numbers each lane's bits consecutively: in the walk's
//   reduce step a thread per (lane, four columns) sums its lane's
//   edges of the batch and adds them to the lane planes, which only this
//   thread block writes (a lane lies in one block, a block in one task),
//   so no atomics and a fixed order.
// Lanes without bits are never touched: the wrapper zero-fills the planes.
//
// Bound. Per edge 6 * dk + 4 * dv flops and an exp; the bytes are the
// plan, q, k, v, dO, lse, D and dq once each, and the lane planes
// (total_blocks * block_w * (dk + dv) floats, mostly zero lanes: 1.3 bits
// a lane on the arxiv proxy) written once. The per-edge gathers of k and v
// rows separate the kernel from it, as in K14.

#include "attn_mh_common.cuh"

namespace {

using namespace voltrix_attn;

// The lane (within the scanned chunk) that edge `e` of the chunk falls in:
// s_pre[lane] <= e < s_pre[lane + 1].
__device__ __forceinline__ int edge_lane(const int* s_pre, int e) {
  int lo = 0, hi = blockDim.x;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_pre[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

// a[0..gw) += coef * row[0..gw), gw 4 (16-byte aligned row) or 1.
__device__ __forceinline__ void axpy_group(float coef, const float* row, bool vec, float4& a) {
  if (vec) {
    axpy4(coef, row, a);
  } else {
    a.x = fmaf(coef, __ldg(row), a.x);
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                const int32_t* __restrict__ hind,      // (B, K)
                const int32_t* __restrict__ wob,       // (B,)
                const int32_t* __restrict__ block_ptr, // (W + 1,)
                const float* __restrict__ q,           // (nq, dk)
                const float* __restrict__ k,           // (nk, dk)
                const float* __restrict__ v,           // (nk, dv)
                const float* __restrict__ g,           // dO, (nq, dv)
                const float* __restrict__ lse,         // (>= nq,)
                const float* __restrict__ drow,        // D, (nq,)
                float* __restrict__ dq,                // (nq, dk), zeroed
                float* __restrict__ dk_lane,           // (B * K, dk), zeroed
                float* __restrict__ dv_lane,           // (B * K, dv), zeroed
                int total_blocks, int words, int block_h, int block_w, int nq, int nk, int dk,
                int dv, int dc, int task_blocks, float scale, float slope, int vec_k,
                int vec_v) {
  extern __shared__ float smem[];
  __shared__ int s_scan[kScanInts];
  const int t = threadIdx.x, nt = blockDim.x;
  const int stride = dc | 1;
  float* s_acc = smem;                                 // (block_h, stride): the dq columns
  float* s_ds = s_acc + (int64_t)block_h * stride;     // (kBatch,) ds in row order
  float* s_lp = s_ds + kBatch;                         // (kBatch,) p in edge order
  float* s_lds = s_lp + kBatch;                        // (kBatch,) ds in edge order
  int* s_lrow = reinterpret_cast<int*>(s_lds + kBatch);  // (kBatch,) row in edge order, or -1
  int* s_cnt = s_lrow + kBatch;                          // (block_h,)
  int* s_off = s_cnt + block_h;                          // (block_h + 1,)
  int* s_esrc = s_off + block_h + 1;                     // (kBatch,) source row in row order
  const int* s_pre = s_scan;                             // the chunk's bit-count scan
  const int c0 = blockIdx.y * dc;
  const int cw = min(dc, dk + dv - c0);  // columns of [dk || dv] in this chunk
  const int cq = max(0, min(cw, dk - c0));  // of which dq / dk_lane columns
  // four columns at a time: whole groups of 4 that stay on one side of dk
  const bool vec = vec_k && vec_v && dc % 4 == 0 && cw % 4 == 0;
  const int gw = vec ? 4 : 1;

  for (int i = t; i < block_h * stride; i += nt) s_acc[i] = 0.f;
  for (int i = t; i < block_h; i += nt) s_cnt[i] = 0;
  for (int i = t; i < kBatch; i += nt) s_lrow[i] = -1;
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
        [&](int r, int src, int slot, int x) {
          const int64_t row = row0 + r;
          const float raw = dot(q + row * dk, k + (int64_t)src * dk, dk, vec_k);
          const float p = expf(act(raw, scale, slope) - __ldg(&lse[row]));
          const float dp = dot(g + row * dv, v + (int64_t)src * dv, dv, vec_v);
          const float ds = p * (dp - __ldg(&drow[row])) * act_grad(raw, slope) * scale;
          s_ds[slot] = ds;
          s_lp[x] = p;
          s_lds[x] = ds;
          s_lrow[x] = r;
        },
        [&](int base, int k0, int kn) {
          // dq: a thread per (row, group of dq columns) sums the row's slots
          const int gq = cq / gw;
          for (int i = t; i < rows * gq; i += nt) {
            const int r = i / gq;
            const int n = s_cnt[r], x0 = s_off[r];
            if (n == 0) continue;
            const int col = c0 + (i % gq) * gw;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int x = x0; x < x0 + n; ++x) {
              axpy_group(s_ds[x], k + (int64_t)s_esrc[x] * dk + col, vec, a);
            }
            float* tile = s_acc + (int64_t)r * stride + (col - c0);
            tile[0] += a.x;
            if (vec) {
              tile[1] += a.y;
              tile[2] += a.z;
              tile[3] += a.w;
            }
          }
          // the lanes: a thread per (lane, group of columns) sums the lane's
          // edges of this batch, which are consecutive in edge order
          const int l_lo = edge_lane(s_pre, k0), l_hi = edge_lane(s_pre, k0 + kn - 1);
          const int groups = cw / gw;
          for (int i = t; i < (l_hi - l_lo + 1) * groups; i += nt) {
            const int l = l_lo + i / groups;
            const int x0 = max(s_pre[l], k0) - k0, x1 = min(s_pre[l + 1], k0 + kn) - k0;
            if (x0 >= x1) continue;
            const int col = c0 + (i % groups) * gw;
            const bool kcol = col < dk;  // dk_lane (sum ds * q) or dv_lane (sum p * dO)
            const float* coef = kcol ? s_lds : s_lp;
            const int ld = kcol ? dk : dv;
            const float* rows_base = kcol ? q + row0 * dk + col : g + row0 * dv + (col - dk);
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int x = x0; x < x1; ++x) {
              if (s_lrow[x] >= 0) axpy_group(coef[x], rows_base + (int64_t)s_lrow[x] * ld, vec, a);
            }
            const int64_t lane = (int64_t)b * block_w + base + l;
            float* dst = kcol ? dk_lane + lane * dk + col : dv_lane + lane * dv + (col - dk);
            if (vec) {
              float4* d4 = reinterpret_cast<float4*>(dst);
              float4 cur = *d4;
              cur.x += a.x;
              cur.y += a.y;
              cur.z += a.z;
              cur.w += a.w;
              *d4 = cur;
            } else {
              dst[0] += a.x;
            }
          }
          __syncthreads();
          // an edge the walk drops (a row past the window's) leaves -1 here
          for (int x = t; x < kn; x += nt) s_lrow[x] = -1;
        });
    flush_add(s_acc, stride, block_h, 1, rows, cq, w_lo >= b_lo && w_hi <= b_hi,
              [&](int, int r, int c) { return dq + (row0 + r) * dk + c0 + c; });
    __syncthreads();
    b = e;
  }
}

}  // namespace

extern "C" {

// Launches K10 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take). `dq`,
// `dk_lane` and `dv_lane` must be zero-filled. All tensors are float.
int voltrix_attn_bwd(const void* bitmask, const void* hind, const void* wob,
                     const void* block_ptr, const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* drow, void* dq, void* dk_lane,
                     void* dv_lane, int total_blocks, int words, int block_h, int block_w, int nq,
                     int nk, int dk, int dv, int dc, int task_blocks, float scale, float slope,
                     int vec_k, int vec_v, void* stream) {
  if (total_blocks <= 0 || words <= 0 || words * 32 < block_h || block_h <= 0 || block_w <= 0 ||
      nq <= 0 || nk <= 0 || dk < 0 || dv < 0 || dk + dv <= 0 || dc <= 0 ||
      (dk + dv + dc - 1) / dc > 65535 || task_blocks <= 0 || (vec_k && dk % 4) ||
      (vec_v && dv % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = ((int64_t)block_h * (dc | 1) + 2 * block_h + 1 + 5 * kBatch) * 4;
  const dim3 grid((total_blocks + task_blocks - 1) / task_blocks, (dk + dv + dc - 1) / dc);
  return launch_kernel(
      attn_bwd_kernel, grid, smem, stream, static_cast<const uint32_t*>(bitmask),
      static_cast<const int32_t*>(hind), static_cast<const int32_t*>(wob),
      static_cast<const int32_t*>(block_ptr), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(drow), static_cast<float*>(dq),
      static_cast<float*>(dk_lane), static_cast<float*>(dv_lane), total_blocks, words, block_h,
      block_w, nq, nk, dk, dv, dc, task_blocks, scale, slope, vec_k, vec_v);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

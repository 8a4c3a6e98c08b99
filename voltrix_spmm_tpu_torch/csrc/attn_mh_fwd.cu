// Kernel K13: multi-head fused graph attention, forward, for sm_90a. For
// head h and destination row r with in-neighbours l (the plan's set bits):
//
//   s = leaky_relu(scale * q[h, r] . k[h, l], slope)
//   out[h, r] = sum_l exp(s - m_r) v[h, l] / max(l_r, 1e-30),   lse[h, r] = m_r + log(l_r)
//
// with m_r the row's largest score and l_r = sum_l exp(s - m_r). A row with
// no edges, and every row of an empty window, gets out 0 and lse 1e30.
//
// Replaces voltrix_spmm_tpu/ops/attention_mh.py:_attn_fwd_mh_kernel together
// with the pair-packed [k || v] gather it consumes. The TPU expands each
// group's bitmask to a (block_h, U*K) tile, scores it on the MXU and carries
// an online softmax (m, l, acc) from grid step to grid step of one window.
// Here q (H, nq, dk), k (H, nk, dk) and v (H, nk, dv) are read as they are,
// gathered by hind inside the kernel; k and v are float or bf16 (the bf16
// plane), q float; m, l and acc are float.
//
// Design (see attn_mh_common.cuh for the task split and the edge walks).
// One thread block per (task, group of heads, chunk of dc <= 128 columns
// of v). Each edge's score goes into shared memory in row order
// (for_each_edge_batch), and each batch is folded into the rows' running
// (m, l, acc) as the TPU kernel folds each group of blocks (the online
// softmax): a thread per row takes the batch's largest score m', turns
// the row's scores into p = exp(s - m') and rescales l by exp(m - m');
// then a thread per (head, row, four columns) rescales those columns of
// acc likewise and adds sum p * v. A batch's sums over a row (of p, and
// of p * v) are taken in double and rounded to float once: the row sort
// places a row's edges in the order its integer atomics ran, and a float
// sum would round differently from run to run, where the double sum's
// float almost never changes. So the output is the same from run to run,
// and a score within rounding of leaky_relu's kink in the next layer
// falls on the same side every time. No per-edge value leaves the block. A
// window wholly inside one task is finished there. A window cut over
// several tasks leaves each task's (m, l, acc) share in a scratch slot; the
// last of its tasks to finish (a counter per window, head group and chunk)
// merges the shares in task order, rescaling each by exp(m_share - M).
//
// Bound. Per edge and head the work is 2 * (dk + dv) flops and an exp;
// the bytes are the plan, q, k, v, out and lse once each, which k and v's
// L2-resident re-reads (one per edge and head) exceed many times over on
// the arxiv proxy: the gathers, not the flops, separate the kernel from its
// bound.

#include "attn_mh_common.cuh"

namespace {

using namespace voltrix_attn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_mh_fwd_kernel(const uint32_t* __restrict__ bitmask,  // (B, words, K)
                   const int32_t* __restrict__ hind,      // (B, K)
                   const int32_t* __restrict__ wob,       // (B,)
                   const int32_t* __restrict__ block_ptr, // (W + 1,)
                   const float* __restrict__ q,           // (H, nq, dk)
                   const T* __restrict__ k,               // (H, nk, dk)
                   const T* __restrict__ v,               // (H, nk, dv)
                   float* __restrict__ out,               // (H, nq, dv), zeroed
                   float* __restrict__ lse,               // (H, W * block_h), 1e30
                   float* __restrict__ part,              // shares of cut windows
                   int* __restrict__ count,               // (W, head groups, chunks), zeroed
                   int total_blocks, int words, int block_h, int block_w, int num_windows,
                   int heads, int head_group, int nq, int nk, int dk, int dv, int dc,
                   int task_blocks, float scale, float slope, int vec_k, int vec_v) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  __shared__ int s_scan[kScanInts];
  const int h0 = blockIdx.y * head_group;
  const int hg = min(head_group, heads - h0);  // this block's heads
  const int stride = dc | 1;  // odd: a warp's rows rarely share a bank
  const int64_t tile_rows = (int64_t)hg * block_h;
  float* s_m = smem;                       // (hg, block_h) row maxima
  float* s_l = s_m + tile_rows;            // (hg, block_h) denominators
  float* s_acc = s_l + tile_rows;          // (hg, block_h, stride) sums of p * v
  float* s_corr = s_acc + tile_rows * stride;  // (hg, block_h) a batch's rescale exp(m - m')
  float* s_p = s_corr + tile_rows;  // (hg, kBatch) a batch's scores, then p, in row order
  int* s_cnt = reinterpret_cast<int*>(s_p + hg * kBatch);  // (block_h,)
  int* s_off = s_cnt + block_h;                            // (block_h + 1,)
  int* s_esrc = s_off + block_h + 1;                       // (kBatch,)

  const int chunks = gridDim.z, chunk = blockIdx.z;
  const int c0 = chunk * dc;
  const int cw = min(dc, dv - c0);
  const bool vec_sum = vec_v && dc % 4 == 0 && cw % 4 == 0;  // four columns at a time
  const int groups = vec_sum ? cw / 4 : cw;
  const int64_t share_size = (int64_t)block_h * (dc + 2);
  const int64_t padded = (int64_t)num_windows * block_h;

  auto clear = [&]() {
    for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) {
      s_m[i] = kNeg;
      s_l[i] = 0.f;
    }
    for (int i = threadIdx.x; i < tile_rows * stride; i += blockDim.x) s_acc[i] = 0.f;
  };
  clear();
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
    auto score = [&](int h, int r, int src) {
      return act(dot(q + ((int64_t)h * nq + row0 + r) * dk, k + ((int64_t)h * nk + src) * dk,
                     dk, vec_k),
                 scale, slope);
    };
    for_each_edge_batch(
        bitmask, hind, b, e, words, block_w, rows, nk, s_scan, s_cnt, s_off, s_esrc,
        [&](int r, int src, int slot, int) {
          for (int j = 0; j < hg; ++j) s_p[j * kBatch + slot] = score(h0 + j, r, src);
        },
        [&](int, int, int) {
          // the rows' maxima, p and denominators: a thread per (head, row)
          for (int i = threadIdx.x; i < hg * rows; i += blockDim.x) {
            const int j = i / rows, r = i % rows;
            const int n = s_cnt[r], e0 = s_off[r];
            if (n == 0) continue;
            float* p = s_p + j * kBatch;
            const int jr = j * block_h + r;
            float m = s_m[jr];
            for (int x = e0; x < e0 + n; ++x) m = fmaxf(m, p[x]);
            double l = 0.0;
            for (int x = e0; x < e0 + n; ++x) {
              p[x] = expf(p[x] - m);
              l += p[x];
            }
            s_corr[jr] = expf(s_m[jr] - m);
            s_l[jr] = s_l[jr] * s_corr[jr] + static_cast<float>(l);
            s_m[jr] = m;
          }
          __syncthreads();
          // the columns: a thread per (head, row, four columns)
          for (int i = threadIdx.x; i < hg * rows * groups; i += blockDim.x) {
            const int j = i / (rows * groups);
            const int r = (i / groups) % rows;
            const int cg = i % groups;
            const int n = s_cnt[r], e0 = s_off[r];
            if (n == 0) continue;
            const float* p = s_p + j * kBatch;
            const float corr = s_corr[j * block_h + r];
            const T* vh = v + (int64_t)(h0 + j) * nk * dv + c0;
            float* tile = s_acc + ((int64_t)j * block_h + r) * stride;
            if (vec_sum) {
              double a[4] = {0.0, 0.0, 0.0, 0.0};
              for (int x = e0; x < e0 + n; ++x) {
                const float4 y = load4(vh + (int64_t)s_esrc[x] * dv + 4 * cg);
                a[0] = fma(static_cast<double>(p[x]), static_cast<double>(y.x), a[0]);
                a[1] = fma(static_cast<double>(p[x]), static_cast<double>(y.y), a[1]);
                a[2] = fma(static_cast<double>(p[x]), static_cast<double>(y.z), a[2]);
                a[3] = fma(static_cast<double>(p[x]), static_cast<double>(y.w), a[3]);
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                tile[4 * cg + c] = fmaf(tile[4 * cg + c], corr, static_cast<float>(a[c]));
              }
            } else {
              double a = 0.0;
              for (int x = e0; x < e0 + n; ++x) {
                a = fma(static_cast<double>(p[x]),
                        static_cast<double>(to_f(vh[(int64_t)s_esrc[x] * dv + cg])), a);
              }
              tile[cg] = fmaf(tile[cg], corr, static_cast<float>(a));
            }
          }
        });

    if (w_lo >= b_lo && w_hi <= b_hi) {
      // the task holds the whole window: finish its rows
      for (int i = threadIdx.x; i < hg * rows * cw; i += blockDim.x) {
        const int j = i / (rows * cw), r = (i / cw) % rows, c = i % cw;
        out[((int64_t)(h0 + j) * nq + row0 + r) * dv + c0 + c] =
            s_acc[((int64_t)j * block_h + r) * stride + c] / fmaxf(s_l[j * block_h + r], 1e-30f);
      }
      if (chunk == 0) {
        for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) {
          const int j = i / block_h, r = i % block_h;
          lse[(h0 + j) * padded + row0 + r] =
              s_l[i] > 0.f ? s_m[i] + logf(fmaxf(s_l[i], 1e-30f)) : kEmptyLse;
        }
      }
    } else {
      // a share of a window cut over several tasks: (m, l, acc) of each head
      // into this task's slot (2 per task: its first run and its last one)
      const int64_t slot = 2 * (int64_t)blockIdx.x + (b != b_lo);
      for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) {
        const int j = i / block_h, r = i % block_h;
        float* mine = part + ((slot * heads + h0 + j) * chunks + chunk) * share_size;
        mine[r] = s_m[i];
        mine[block_h + r] = s_l[i];
      }
      for (int i = threadIdx.x; i < tile_rows * cw; i += blockDim.x) {
        const int j = i / (block_h * cw), r = (i / cw) % block_h, c = i % cw;
        float* mine = part + ((slot * heads + h0 + j) * chunks + chunk) * share_size;
        mine[2 * block_h + r * dc + c] = s_acc[((int64_t)j * block_h + r) * stride + c];
      }
      __threadfence();  // the shares are visible before the counter moves
      __syncthreads();
      const int t_first = w_lo / task_blocks, t_last = (w_hi - 1) / task_blocks;
      if (threadIdx.x == 0) {
        const int64_t counter = ((int64_t)w * gridDim.y + blockIdx.y) * chunks + chunk;
        s_last = atomicAdd(&count[counter], 1) == t_last - t_first;
      }
      __syncthreads();
      if (s_last) {
        // the window's last task: merge the shares in task order
        __threadfence();
        auto share = [&](int tt, int h) {
          const int sl = 2 * tt + (tt == t_first && w_lo != tt * task_blocks);
          return part + (((int64_t)sl * heads + h) * chunks + chunk) * share_size;
        };
        for (int i = threadIdx.x; i < tile_rows * cw; i += blockDim.x) {
          const int j = i / (block_h * cw), r = (i / cw) % block_h, c = i % cw;
          const int h = h0 + j;
          float m = kNeg;
          for (int tt = t_first; tt <= t_last; ++tt) m = fmaxf(m, __ldcg(share(tt, h) + r));
          float l = 0.f, a = 0.f;
          for (int tt = t_first; tt <= t_last; ++tt) {
            const float* sh = share(tt, h);
            const float f = expf(__ldcg(sh + r) - m);
            l = fmaf(__ldcg(sh + block_h + r), f, l);
            a = fmaf(__ldcg(sh + 2 * block_h + r * dc + c), f, a);
          }
          if (r < rows) out[((int64_t)h * nq + row0 + r) * dv + c0 + c] = a / fmaxf(l, 1e-30f);
          if (chunk == 0 && c == 0) {
            lse[h * padded + row0 + r] = l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : kEmptyLse;
          }
        }
      }
    }
    b = e;
    if (b < b_hi) {  // clear the tile for the next run
      __syncthreads();
      clear();
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* bitmask, const void* hind, const void* wob, const void* block_ptr,
           const void* q, const void* k, const void* v, void* out, void* lse, void* part,
           void* count, int total_blocks, int words, int block_h, int block_w, int num_windows,
           int heads, int head_group, int nq, int nk, int dk, int dv, int dc, int task_blocks,
           float scale, float slope, int vec_k, int vec_v, void* stream) {
  const int hg = min(head_group, heads);
  const int64_t smem = ((int64_t)hg * block_h * ((dc | 1) + 3) + 2 * block_h + 1 +
                        (int64_t)(hg + 1) * kBatch) * 4;
  const dim3 grid((total_blocks + task_blocks - 1) / task_blocks,
                  (heads + head_group - 1) / head_group, (dv + dc - 1) / dc);
  return launch_kernel(
      attn_mh_fwd_kernel<T>, grid, smem, stream, static_cast<const uint32_t*>(bitmask),
      static_cast<const int32_t*>(hind), static_cast<const int32_t*>(wob),
      static_cast<const int32_t*>(block_ptr), static_cast<const float*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<float*>(part), static_cast<int*>(count),
      total_blocks, words, block_h, block_w, num_windows, heads, head_group, nq, nk, dk, dv, dc,
      task_blocks, scale, slope, vec_k, vec_v);
}

}  // namespace

extern "C" {

// Launches K13 on `stream` and returns cudaGetLastError() as an int (0 on
// success; cudaErrorInvalidValue for a geometry it does not take). `out`
// must be zero-filled, `lse` filled with 1e30 and `count` (num_windows *
// head groups * chunks ints) zero-filled; `part` holds 2 * tasks * heads *
// chunks * block_h * (dc + 2) floats, tasks = ceil(total_blocks /
// task_blocks), chunks = ceil(dv / dc). One thread block serves head_group
// heads (at most 8). k and v are bf16 when bf16 != 0, else float.
int voltrix_attn_mh_fwd(const void* bitmask, const void* hind, const void* wob,
                        const void* block_ptr, const void* q, const void* k, const void* v,
                        void* out, void* lse, void* part, void* count, int total_blocks,
                        int words, int block_h, int block_w, int num_windows, int heads,
                        int head_group, int nq, int nk, int dk, int dv, int dc, int task_blocks,
                        float scale, float slope, int vec_k, int vec_v, int bf16, void* stream) {
  if (total_blocks <= 0 || words <= 0 || words * 32 < block_h || block_h <= 0 || block_w <= 0 ||
      num_windows <= 0 || heads <= 0 || head_group <= 0 || head_group > kMaxHeadGroup ||
      (heads + head_group - 1) / head_group > 65535 || nq <= 0 || nk <= 0 || dk <= 0 ||
      dv <= 0 || dc <= 0 || (dv + dc - 1) / dc > 65535 || task_blocks <= 0 ||
      (vec_k && dk % 4) || (vec_v && dv % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<__nv_bfloat16>(bitmask, hind, wob, block_ptr, q, k, v, out, lse, part,
                                      count, total_blocks, words, block_h, block_w, num_windows,
                                      heads, head_group, nq, nk, dk, dv, dc, task_blocks, scale,
                                      slope, vec_k, vec_v, stream)
              : launch<float>(bitmask, hind, wob, block_ptr, q, k, v, out, lse, part, count,
                              total_blocks, words, block_h, block_w, num_windows, heads,
                              head_group, nq, nk, dk, dv, dc, task_blocks, scale, slope, vec_k,
                              vec_v, stream);
}

const char* voltrix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

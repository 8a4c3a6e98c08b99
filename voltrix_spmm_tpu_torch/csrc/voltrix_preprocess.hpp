// Native window preprocessing: CSR -> binned block-CSR plan, on the host.
//
// The port's own copy of the JAX package's C++/OpenMP plan preprocess
// (voltrix_spmm_tpu/csrc/voltrix_preprocess.hpp), with the same
// arithmetic, so both build the same plans bit for bit, and the numpy
// path of format/preprocess.py too. It runs on the host CPU,
// parallelised with OpenMP over row windows; each window's part of the
// plan depends on that window alone, so the thread count changes no bit.
//
// Two-pass contract (caller = voltrix_spmm_tpu_torch/runtime/native.py):
//   pass 1 analyze_windows: per-window sorted unique columns + counts
//   (python computes the block prefix sum)
//   pass 2 fill_plan: hind gather map + row-packed bitmask + exact nnz.
#pragma once

#include <algorithm>
#include <cstdint>
#include <vector>

namespace voltrix_torch {

// uniq_cols has capacity nnz; window w's unique column *segments*
// (column ids divided by `seg`; seg=1 -> plain columns) are written at
// the window's first edge offset indptr[w*W] (#uniques <= #edges).
inline int analyze_windows(const int* indptr, const int* indices,
                           long long num_nodes, long long window_rows,
                           long long seg, int* uniq_cols, int* win_unique) {
  const long long W = window_rows;
  const long long num_windows = (num_nodes + W - 1) / W;
#pragma omp parallel
  {
    std::vector<int> buf;
#pragma omp for schedule(dynamic, 1)
    for (long long w = 0; w < num_windows; ++w) {
      const long long r0 = w * W;
      const long long r1 = std::min((w + 1) * W, num_nodes);
      const long long e0 = indptr[r0], e1 = indptr[r1];
      buf.resize(e1 - e0);
      for (long long e = e0; e < e1; ++e)
        buf[e - e0] = indices[e] / static_cast<int>(seg);
      std::sort(buf.begin(), buf.end());
      buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
      win_unique[w] = static_cast<int>(buf.size());
      std::copy(buf.begin(), buf.end(), uniq_cols + e0);
    }
  }
  return 0;
}

inline int fill_plan(const int* indptr, const int* indices,
                     long long num_nodes, long long window_rows,
                     long long block_cols, long long seg,
                     const int* uniq_cols, const int* win_unique,
                     const long long* block_ptr, int* hind,
                     unsigned int* bitmask, long long words,
                     long long* nnz_out) {
  const long long W = window_rows, K = block_cols;
  const long long num_windows = (num_nodes + W - 1) / W;
  long long nnz_dedup = 0;
#pragma omp parallel for schedule(dynamic, 1) reduction(+ : nnz_dedup)
  for (long long w = 0; w < num_windows; ++w) {
    const long long r0 = w * W;
    const long long r1 = std::min((w + 1) * W, num_nodes);
    const long long e0 = indptr[r0];
    const int* uc = uniq_cols + e0;
    const int U = win_unique[w];
    const long long b0 = block_ptr[w];
    const long long lanes = (block_ptr[w + 1] - b0) * K;
    for (long long p = 0; p < lanes; ++p) {
      // lane p holds covered row uc[p/seg]*seg + p%seg (may exceed
      // num_nodes-1 at the tail; its bits stay zero, consumers pad/clip).
      // Padding lanes carry the canonical [0..seg) run so every seg-lane
      // group stays a valid aligned DMA descriptor.
      const int base = (p < U * seg) ? uc[p / seg] * static_cast<int>(seg) : 0;
      hind[(b0 + p / K) * K + (p % K)] = base + static_cast<int>(p % seg);
    }
    for (long long r = r0; r < r1; ++r) {
      const int rl = static_cast<int>(r - r0);
      const unsigned int bit = 1u << (rl % 32);
      const long long word_row = rl / 32;
      for (long long e = indptr[r]; e < indptr[r + 1]; ++e) {
        const int cseg = indices[e] / static_cast<int>(seg);
        const long long p =
            (std::lower_bound(uc, uc + U, cseg) - uc) * seg + indices[e] % seg;
        const long long b = b0 + p / K;
        unsigned int& wordref = bitmask[(b * words + word_row) * K + (p % K)];
        nnz_dedup += (wordref & bit) ? 0 : 1;  // exact dedup'd edge count
        wordref |= bit;
      }
    }
  }
  *nnz_out = nnz_dedup;
  return 0;
}

// Two-level column clustering (the native twin of format/cluster.py
// cluster_window_columns + block_occupancy): within each window, sort
// lane RUNS of `seg` lanes (seg == 1 -> single lanes) by (empty-last,
// sub-window signature, head column id) and permute (hind, bitmask)
// lane columns in place; emit the per-block occupancy bitmap the
// subtile kernel K2 skips by. Runs move as units so seg-aligned plans
// keep the aligned runs that kernel K3 fetches (ops/fused_spmm.py).
// Window-local buffers keep the whole pass cache-resident and
// OpenMP-parallel over windows, where the vectorized numpy path
// shuffles the whole bitmask through three strided copies.
inline int cluster_windows(long long num_windows, long long words,
                           long long K, long long seg,
                           const long long* block_ptr,
                           int* hind, unsigned int* bitmask, int* occ) {
  const long long wps = 4;  // words per 128-row sub-window (128/32)
  if (seg < 1 || K % seg != 0) return 1;
#pragma omp parallel
  {
    std::vector<long long> runs;
    std::vector<unsigned long long> sig;   // per lane
    std::vector<unsigned long long> rsig;  // per run (OR of members)
    std::vector<int> hbuf;
    std::vector<unsigned int> bbuf;
#pragma omp for schedule(dynamic, 1)
    for (long long w = 0; w < num_windows; ++w) {
      const long long b0 = block_ptr[w], b1 = block_ptr[w + 1];
      const long long L = (b1 - b0) * K;
      if (L == 0) continue;
      const long long G = L / seg;
      sig.assign(L, 0ull);
      for (long long b = b0; b < b1; ++b)
        for (long long wd = 0; wd < words; ++wd) {
          const unsigned int* row = bitmask + (b * words + wd) * K;
          const unsigned long long sb = 1ull << (wd / wps);
          unsigned long long* sg = sig.data() + (b - b0) * K;
          for (long long j = 0; j < K; ++j)
            if (row[j]) sg[j] |= sb;
        }
      rsig.assign(G, 0ull);
      for (long long g = 0; g < G; ++g)
        for (long long t = 0; t < seg; ++t) rsig[g] |= sig[g * seg + t];
      const int* hwin = hind + b0 * K;  // lane i <-> hwin[i] (contiguous)
      runs.resize(G);
      for (long long g = 0; g < G; ++g) runs[g] = g;
      std::sort(runs.begin(), runs.end(),
                [&](long long x, long long y) {
                  const bool ex = rsig[x] == 0, ey = rsig[y] == 0;
                  if (ex != ey) return ey;  // padding runs last
                  if (rsig[x] != rsig[y]) return rsig[x] < rsig[y];
                  return hwin[x * seg] < hwin[y * seg];  // gather locality
                });
      hbuf.assign(hwin, hwin + L);
      bbuf.assign(bitmask + b0 * words * K, bitmask + b1 * words * K);
      for (long long g = 0; g < G; ++g) {
        for (long long t = 0; t < seg; ++t) {
          const long long src = runs[g] * seg + t;
          const long long dst = g * seg + t;
          hind[b0 * K + dst] = hbuf[src];
          const long long sb = src / K, sj = src % K;
          const long long db = dst / K, dj = dst % K;
          for (long long wd = 0; wd < words; ++wd)
            bitmask[((b0 + db) * words + wd) * K + dj] =
                bbuf[(sb * words + wd) * K + sj];
          occ[b0 + db] |= static_cast<int>(
              static_cast<unsigned int>(sig[src] & 0xffffffffull));
        }
      }
    }
  }
  return 0;
}

}  // namespace voltrix_torch

namespace voltrix_torch {

// Host CSR SpMM oracle: out[n, d] = A @ x with implicit 1.0 values
// (binary adjacency), accumulated in float32 in CSR order: a host check
// of large problems that is cheaper than scipy's float64 product.
inline int csr_spmm_f32(const int* indptr, const int* indices,
                        long long num_rows, const float* x, long long d,
                        float* out) {
#pragma omp parallel for schedule(dynamic, 64)
  for (long long r = 0; r < num_rows; ++r) {
    float* dst = out + r * d;
    for (long long j = 0; j < d; ++j) dst[j] = 0.0f;
    for (long long e = indptr[r]; e < indptr[r + 1]; ++e) {
      const float* src = x + static_cast<long long>(indices[e]) * d;
      for (long long j = 0; j < d; ++j) dst[j] += src[j];
    }
  }
  return 0;
}

}  // namespace voltrix_torch

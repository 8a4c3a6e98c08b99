"""The hybrid split plan: a coverage part for dense runs plus an exact part
for the scattered rest (counterpart of voltrix_spmm_tpu/format/hybrid.py).

SpMM is additive over a partition of the edges, A = A_dense + A_sparse:

- the edges of (window, gather_segment-run) pairs that carry at least
  `threshold` distinct neighbour columns go to A_dense, a coverage plan
  (gather_segment > 1) that kernel K3 runs;
- the rest go to A_sparse, an exact plan (gather_segment 1) that K1, or K2
  on clustered plans, runs.

The split uses the JAX package's numpy passes, so both packages build the
same two plans bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .plan import PlanConfig, SpmmPlan
from .preprocess import csr_preprocess, plan_stats


@dataclass
class HybridPlan:
    dense: SpmmPlan  # coverage plan (gather_segment > 1)
    sparse: SpmmPlan  # exact plan (gather_segment == 1)
    num_nodes: int
    num_edges: int

    def to(self, device) -> "HybridPlan":
        """A copy with both plans on `device` (see SpmmPlan.to)."""
        return dataclasses.replace(self, dense=self.dense.to(device),
                                   sparse=self.sparse.to(device))


def _edges_to_csr(rows, cols, num_nodes):
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_nodes), out=indptr[1:])
    return indptr, cols


def csr_preprocess_hybrid(
    indptr,
    indices,
    num_nodes: int,
    dense_config: PlanConfig = PlanConfig(128, 128, 8),
    sparse_config: PlanConfig | None = None,
    threshold: int | None = None,
    backend: str = "numpy",
) -> HybridPlan:
    """Split the edges by run occupancy and build both plans (on the CPU).

    threshold: the fewest distinct neighbours a (window, seg-run) must
    carry to be fetched as a dense run (default seg // 2, at least 2: at
    most 2x coverage waste in the dense part). The default sparse_config
    is PlanConfig(max(block_h, 512), block_w, 1, block_unroll=max(unroll,
    4)) with the dense side's cluster_cols, as in the JAX package."""
    seg = dense_config.gather_segment
    if seg < 2:
        raise ValueError("hybrid needs a coverage dense_config (gather_segment > 1)")
    if sparse_config is None:
        sparse_config = PlanConfig(
            max(dense_config.block_h, 512),
            dense_config.block_w,
            1,
            block_unroll=max(dense_config.block_unroll, 4),
            cluster_cols=dense_config.cluster_cols,
        )
    if sparse_config.gather_segment != 1:
        raise ValueError("the sparse side needs exact lanes (gather_segment == 1)")
    if threshold is None:
        threshold = max(seg // 2, 2)

    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    key = np.unique(rows * num_nodes + indices)  # deduplicated edges
    rows, cols = key // num_nodes, key % num_nodes
    nnz = rows.shape[0]

    if nnz == 0:
        empty_ptr = np.zeros(num_nodes + 1, np.int64)
        none = np.zeros(0, np.int64)
        return HybridPlan(
            dense=csr_preprocess(empty_ptr, none, num_nodes, dense_config, backend),
            sparse=csr_preprocess(empty_ptr, none, num_nodes, sparse_config, backend),
            num_nodes=num_nodes,
            num_edges=0,
        )

    # run occupancy counts DISTINCT neighbour columns per (window, segment):
    # a hub column that many rows of a window reference is one fetched column
    nseg = -(-num_nodes // seg)
    w = rows // dense_config.block_h
    wcol = np.unique(w * num_nodes + cols)
    run_of_wcol = (wcol // num_nodes) * nseg + (wcol % num_nodes) // seg
    uniq_runs, distinct_cols = np.unique(run_of_wcol, return_counts=True)
    run_key = w * nseg + cols // seg
    dense_edge = distinct_cols[np.searchsorted(uniq_runs, run_key)] >= threshold

    dptr, dcols = _edges_to_csr(rows[dense_edge], cols[dense_edge], num_nodes)
    sptr, scols = _edges_to_csr(rows[~dense_edge], cols[~dense_edge], num_nodes)
    return HybridPlan(
        dense=csr_preprocess(dptr, dcols, num_nodes, dense_config, backend),
        sparse=csr_preprocess(sptr, scols, num_nodes, sparse_config, backend),
        num_nodes=num_nodes,
        num_edges=int(nnz),
    )


def hybrid_stats(plan: HybridPlan) -> dict:
    d, s = plan_stats(plan.dense), plan_stats(plan.sparse)
    return {
        "num_edges": plan.num_edges,
        "dense_frac": d["nnz"] / max(plan.num_edges, 1),
        "dense": d,
        "sparse": s,
        "total_gather_rows": d["gather_rows"] + s["gather_rows"],
    }

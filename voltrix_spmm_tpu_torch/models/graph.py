"""Graph container and neighbour aggregation on the SpMM kernel
(counterpart of voltrix_spmm_tpu/models/graph.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..format.plan import PlanConfig, SpmmPlan
from ..format.preprocess import csr_preprocess
from ..format.stream import slice_plan_windows
from ..ops.autodiff import spmm_ad


@dataclass
class GraphData:
    plan: SpmmPlan | list  # A, or its window chunks (build_graph(stream_chunks=))
    plan_t: SpmmPlan | list  # A^T (the same object for symmetric graphs)
    inv_deg: torch.Tensor  # float32 (N, 1): 1/max(out-degree, 1)
    inv_sqrt_deg: torch.Tensor  # float32 (N, 1): max(out-degree, 1)^-1/2

    @property
    def num_nodes(self) -> int:
        # window chunks partition the output rows
        if isinstance(self.plan, (list, tuple)):
            return sum(p.num_nodes for p in self.plan)
        return self.plan.num_nodes


def build_graph(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig = PlanConfig(),
    symmetric: bool | None = None,
    stream_chunks: int | None = None,
    device="cuda",
) -> GraphData:
    """Preprocess the adjacency into plans for A and A^T and the degree
    normalisations, and move them to `device` (the card unless the caller
    asks for the CPU) once, so requests never upload the plan again.

    `config` is a PlanConfig, by default the JAX package's PlanConfig()
    (128-row windows of 128 lanes). A string is refused: the JAX
    package's "auto" picks from constants measured on a TPU, and the H100
    tuner is ROADMAP.md item 9. Every binary config builds: the default
    windows (kernel K1), column-clustered tall windows such as
    PlanConfig(2048, 128, block_unroll=4, cluster_cols=True) (K2), and
    coverage plans such as PlanConfig(2048, 128, gather_segment=128,
    block_unroll=4) (K3); `spmm_ad` picks the kernel from each plan.

    stream_chunks=k > 1 cuts the plan, and on an asymmetric graph the
    transpose plan, into k window chunks (`format.stream.slice_plan_windows`);
    `spmm_ad` then runs the chunks one after another, each on the kernel
    its plan takes, and each output row is summed as on the whole plan."""
    import scipy.sparse as sp

    if not isinstance(config, PlanConfig):
        raise NotImplementedError(
            f"config={config!r}: pass an explicit PlanConfig (the H100 tuner "
            "that would pick one is ROADMAP.md item 9)"
        )
    chunked = bool(stream_chunks and stream_chunks > 1)

    def place(p):
        if chunked:
            return [s.to(device) for s in slice_plan_windows(p, stream_chunks)]
        return p.to(device)

    plan = csr_preprocess(indptr, indices, num_nodes, config)
    a = sp.csr_matrix(
        (
            np.ones(np.asarray(indices).shape[0], dtype=np.float32),
            np.asarray(indices),
            np.asarray(indptr),
        ),
        shape=(num_nodes, num_nodes),
    )
    at = a.T.tocsr()
    if symmetric is None:
        symmetric = (a != at).nnz == 0
    if symmetric:
        plan = plan_t = place(plan)
    else:
        plan_t = csr_preprocess(at.indptr, at.indices, num_nodes, config)
        plan, plan_t = place(plan), place(plan_t)
    deg = np.asarray(a.sum(axis=1)).reshape(num_nodes, 1)
    inv_deg = (1.0 / np.maximum(deg, 1.0)).astype(np.float32)
    inv_sqrt_deg = (1.0 / np.sqrt(np.maximum(deg, 1.0))).astype(np.float32)
    return GraphData(
        plan=plan,
        plan_t=plan_t,
        inv_deg=torch.from_numpy(inv_deg).to(device),
        inv_sqrt_deg=torch.from_numpy(inv_sqrt_deg).to(device),
    )


def aggregate(g: GraphData, x: torch.Tensor, mode: str = "mean", *, impl: str = "auto"):
    """Neighbour aggregation sum_j A[i,j] x[j], optionally normalised.

    Accepts (N, D) or a graph-batched (B, N, D); the batch folds into the
    feature axis, so one kernel launch serves the whole batch.

    mode: "sum" (A @ x), "mean" (D^-1 A x), "sym" (D^-1/2 A D^-1/2 x).
    impl: "auto" (the plan's kernel on the card: K1, K2 for clustered
    plans, K3 for coverage plans, chunk by chunk on a streamed graph) or
    "reference" (plain version).
    """
    if x.dim() == 3:
        b, n, d = x.shape
        flat = x.permute(1, 0, 2).reshape(n, b * d)
        out = aggregate(g, flat, mode, impl=impl)
        return out.reshape(n, b, d).permute(1, 0, 2)
    if mode == "sym":
        pre = (g.inv_sqrt_deg * x).to(x.dtype)
        return (g.inv_sqrt_deg * spmm_ad(g.plan, g.plan_t, pre, impl=impl)).to(x.dtype)
    out = spmm_ad(g.plan, g.plan_t, x, impl=impl)
    if mode == "mean":
        return g.inv_deg * out
    if mode != "sum":
        raise ValueError(f"unknown aggregation mode {mode!r}")
    return out

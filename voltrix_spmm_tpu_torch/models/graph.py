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
    # the dtype `aggregate` streams the features in (None: x's own); with
    # torch.bfloat16 or torch.float16 the kernels read 16-bit rows and sum in
    # float32, and the result returns in x's dtype (the JAX package's
    # agg_dtype)
    agg_dtype: torch.dtype | None = None

    @property
    def num_nodes(self) -> int:
        # window chunks partition the output rows
        if isinstance(self.plan, (list, tuple)):
            return sum(p.num_nodes for p in self.plan)
        return self.plan.num_nodes


# build_graph(config="auto")'s rule, set on the card (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6): K3's coverage plan needs
# FUSED_COVERAGE_THRESHOLD's gate and at least AUTO_FUSED_MIN_NODES rows,
# four windows of 2048. On uniform graphs of about 600 edges a row (the
# protein and ogbl-ddi proxies' family; tools/auto_sweep.py) the gate
# passes at every size, but K3 ran 2.14x / 1.25x the winner at 4,267 rows
# (three windows; d 128 / 256) and won from 8,192 rows on (0.94x / 0.87x
# the best other; 0.58-0.65x from 16,384 to 65,536, 0.66x on C's 132,534);
# the crossing between 4,267 and 8,192 is not resolved. Every other graph
# takes PlanConfig(), K1 on 128-row windows, which won A's race (0.3835 ms
# at d 128; clustered 1024- and 2048-row windows 0.430 and 0.463), where
# the JAX package takes K2 on 2048 rows.
AUTO_FUSED_MIN_NODES = 8192
# build_graph(config="auto") leaves agg_dtype at None (float32 rows) where
# the JAX package's rule (voltrix_spmm_tpu/models/graph.py:179-191) streams
# bf16 rows: on plans without gather runs (gather_segment 1) of at least
# 65,536 rows. Set on the card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
# path Q, PERF.md section 6): on A's graph (the ogbn-arxiv proxy, 169,343
# rows, which the JAX rule sends to bf16) K1's bf16 instantiation takes
# 0.484 / 0.886 ms at d 128 / 256 against 0.389 / 0.709 for float32 rows
# (1.24x / 1.25x: the walk's instructions, not X's bytes, set its time),
# and the GCN request 2.789 against 2.036 ms (1.37x), the step 5.628
# against 4.170 (1.35x).
# the features' nominal width when build_graph("auto") sizes window chunks:
# 512 bytes a row of float32, the JAX package's nominal row
AUTO_NOMINAL_D = 128


def auto_plan_config(indptr, indices, num_nodes: int) -> PlanConfig:
    """The plan config of `build_graph(config="auto")`, from the graph alone
    (no timing): K3's coverage plan when `fused_auto_config`'s gate passes
    (FUSED_COVERAGE_THRESHOLD rows per nnz at h2048 / seg128) on a graph of
    at least AUTO_FUSED_MIN_NODES rows, else PlanConfig(). The threshold
    and the fallback are the card's (see the constants), not the JAX
    package's, which sends larger scattered graphs to K2 on 2048 rows."""
    from ..format.preprocess import fused_auto_config

    if num_nodes >= AUTO_FUSED_MIN_NODES:
        cfg = fused_auto_config(indptr, indices, num_nodes)
        if cfg is not None:
            return cfg
    return PlanConfig()


def auto_stream_chunks(plan: SpmmPlan, nnz: int,
                       device_mem_bytes: float | None = None) -> int | None:
    """Window chunks for `build_graph(config="auto")`, or None. The port's
    kernels gather no copy of X (the JAX package chunks a plan whose gather
    would not fit), so what a chunk bounds here is the work list's
    workspace: the plan and the features stay whole. Chunks join, 2 to 64,
    only when the residency the tuner estimates (`estimate_residency` at
    AUTO_NOMINAL_D) does not fit the device budget whole."""
    from ..tuner.tuner import Variant, _device_mem_budget, estimate_residency

    cfg = plan.config
    v = Variant("fused" if cfg.gather_segment >= 8 else "pregather", cfg.block_h, cfg.block_w,
                cfg.gather_segment, block_unroll=cfg.block_unroll, subtile=cfg.cluster_cols)
    budget = device_mem_bytes if device_mem_bytes is not None else _device_mem_budget()
    stats = dict(num_nodes=plan.num_nodes, d=AUTO_NOMINAL_D, nnz=nnz,
                 lanes=plan.total_blocks * cfg.block_w)
    for c in (None, 2, 4, 8, 16, 32, 64):
        if estimate_residency(v, chunks=c, **stats) <= budget:
            return c
    return 64


def build_graph(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig | str = PlanConfig(),
    symmetric: bool | None = None,
    stream_chunks: int | None = None,
    device="cuda",
) -> GraphData:
    """Preprocess the adjacency into plans for A and A^T and the degree
    normalisations, and move them to `device` (the card unless the caller
    asks for the CPU) once, so requests never upload the plan again.

    `config` is a PlanConfig, by default the JAX package's PlanConfig()
    (128-row windows of 128 lanes), or "auto": `auto_plan_config` picks it
    from the graph (on an asymmetric graph A^T from its own), and on the
    card window chunks join when `auto_stream_chunks` says the plan's
    residency does not fit it whole (a CPU graph is never chunked). Every binary config builds: the default
    windows (kernel K1), column-clustered tall windows such as
    PlanConfig(2048, 128, block_unroll=4, cluster_cols=True) (K2), and
    coverage plans such as PlanConfig(2048, 128, gather_segment=128,
    block_unroll=4) (K3); `spmm_ad` picks the kernel from each plan.

    stream_chunks=k > 1 cuts the plan, and on an asymmetric graph the
    transpose plan, into k window chunks (`format.stream.slice_plan_windows`);
    `spmm_ad` then runs the chunks one after another, each on the kernel
    its plan takes, and each output row is summed as on the whole plan."""
    import scipy.sparse as sp

    auto = isinstance(config, str) and config == "auto"
    if not (auto or isinstance(config, PlanConfig)):
        raise ValueError(f"unknown config {config!r}: pass a PlanConfig or 'auto'")
    if auto:
        config = auto_plan_config(indptr, indices, num_nodes)
    plan = csr_preprocess(indptr, indices, num_nodes, config)
    if auto and stream_chunks is None and torch.device(device).type == "cuda":
        stream_chunks = auto_stream_chunks(plan, int(np.asarray(indices).shape[0]))
    chunked = bool(stream_chunks and stream_chunks > 1)

    def place(p):
        if chunked:
            return [s.to(device) for s in slice_plan_windows(p, stream_chunks)]
        return p.to(device)

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
        # A^T takes its own coverage gate under "auto": local rows with
        # scattered columns must not give A^T a coverage plan
        config_t = auto_plan_config(at.indptr, at.indices, num_nodes) if auto else config
        plan_t = csr_preprocess(at.indptr, at.indices, num_nodes, config_t)
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

    With `g.agg_dtype` (torch.bfloat16 or torch.float16) x is cast to it
    first, so the kernels read 16-bit rows (and sum in float32); the
    SpMM's 16-bit result returns in x's dtype, with the JAX package's
    rounding points: in sym mode the pre-scaled rows round to it too.
    """
    if x.dim() == 3:
        b, n, d = x.shape
        flat = x.permute(1, 0, 2).reshape(n, b * d)
        out = aggregate(g, flat, mode, impl=impl)
        return out.reshape(n, b, d).permute(1, 0, 2)
    out_dtype = x.dtype
    if g.agg_dtype is not None:
        x = x.to(g.agg_dtype)
    if mode == "sym":
        pre = (g.inv_sqrt_deg * x).to(x.dtype)
        return (g.inv_sqrt_deg * spmm_ad(g.plan, g.plan_t, pre, impl=impl)).to(out_dtype)
    out = spmm_ad(g.plan, g.plan_t, x, impl=impl).to(out_dtype)
    if mode == "mean":
        return g.inv_deg * out
    if mode != "sum":
        raise ValueError(f"unknown aggregation mode {mode!r}")
    return out

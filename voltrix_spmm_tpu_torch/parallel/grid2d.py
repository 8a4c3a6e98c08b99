"""2D-partitioned (SUMMA-style) SpMM over a ("row", "col") mesh
(counterpart of voltrix_spmm_tpu/parallel/grid2d.py).

Rank (i, j) of an (R, C) mesh owns the single rectangular block
A[rows_i, cols_j]:

- adjacency-plan memory per rank ~ nnz / (R * C);
- forward: all-gather of the local X shard over "row", one rectangular
  block SpMM (K1 on the card), reduce-scatter of the partial outputs over
  "col";
- backward (the op is linear in X): the mirror, all-gather of dOut over
  "col", the transpose block's SpMM, reduce-scatter over "row".

Node block b = i * C + j (rows [b * shard, (b + 1) * shard)) lives on rank
(i, j), which is global rank i * C + j of `comm.device_mesh((R, C), ("row",
"col"))`; mesh row i owns the output range of blocks i * C .. i * C + C - 1,
and mesh column j sources the blocks {i' * C + j}, in i' order, which is
what the all-gather over "row" stacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..format.plan import PlanConfig
from ..format.preprocess import csr_preprocess
from ..ops import spmm
from . import comm
from .ring import padded_csr
from .row_sharded import check_rows, device_plan, pad_rows, plan_arrays
from .row_sharded_gcn import FullGraphStep, local_inv_deg


@dataclass
class Grid2DPlan:
    """(R, C) grid of rectangular block plans A[rows_i, cols_j], each C *
    shard output rows x R * shard source columns (column ids local to the
    all-gather over "row"), padded to a common block count."""

    bitmask: np.ndarray  # uint32 (R, C, tb, words, K)
    hind: np.ndarray  # int32 (R, C, tb, K)
    window_of_block: np.ndarray  # int32 (R, C, tb)
    block_ptr: np.ndarray  # int32 (R, C, windows + 1)
    config: PlanConfig
    num_nodes: int  # padded global rows (= R * C * shard)
    shard: int  # rows of node block b = i * C + j
    tb_max: int
    nrow: int
    ncol: int
    # transpose blocks A[rows_i, cols_j]^T for the backward
    bitmask_t: np.ndarray | None = None
    hind_t: np.ndarray | None = None
    window_of_block_t: np.ndarray | None = None
    block_ptr_t: np.ndarray | None = None
    tbt_max: int = 0
    _local: dict = field(default_factory=dict, repr=False, compare=False)

    def local(self, i: int, j: int, device):
        """(block plan, transpose block plan or None) of rank (i, j), moved
        to `device` at the first call and kept."""
        key = (i, j, str(device))
        if key not in self._local:
            out_rows, src_rows = self.ncol * self.shard, self.nrow * self.shard
            fwd = device_plan(self.bitmask[i, j], self.hind[i, j], self.window_of_block[i, j],
                              self.block_ptr[i, j], self.config, out_rows, src_rows,
                              self.tb_max, device)
            bwd = None
            if self.bitmask_t is not None:
                bwd = device_plan(self.bitmask_t[i, j], self.hind_t[i, j],
                                  self.window_of_block_t[i, j], self.block_ptr_t[i, j],
                                  self.config, src_rows, out_rows, self.tbt_max, device)
            self._local[key] = (fwd, bwd)
        return self._local[key]

    def rows_of(self, x, index: int):
        """Node block `index`'s (= i * C + j) rows of the padded global
        array `x`."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"x has {x.shape[0]} rows, the plan {self.num_nodes}")
        return x[index * self.shard: (index + 1) * self.shard]

    def assemble(self, shards):
        """The (num_nodes, ...) array of every block's rows, in block order."""
        return np.concatenate([np.asarray(s) for s in shards])


def _pad_stack_grid2d(plans, config, nrow, ncol):
    """plans[(i, j)] -> stacked arrays padded to tb_max."""
    tb_max = max(max(p.total_blocks for p in plans.values()), 1)
    words, K = config.words_per_col, config.block_w
    nw = next(iter(plans.values())).num_windows
    bm = np.zeros((nrow, ncol, tb_max, words, K), np.uint32)
    hi = np.zeros((nrow, ncol, tb_max, K), np.int32)
    wob = np.zeros((nrow, ncol, tb_max), np.int32)
    bp = np.zeros((nrow, ncol, nw + 1), np.int32)
    for (i, j), p in plans.items():
        t = p.total_blocks
        a_bm, a_hi, a_wob, a_bp = plan_arrays(p)
        bm[i, j, :t] = a_bm
        hi[i, j, :t] = a_hi
        wob[i, j, :t] = a_wob
        wob[i, j, t:] = p.num_windows - 1  # padding accumulates zeros
        bp[i, j, :-1] = a_bp[:-1]
        bp[i, j, -1] = tb_max
    return bm, hi, wob, bp, tb_max


def build_grid2d_plan(
    indptr,
    indices,
    num_nodes: int,
    nrow: int,
    ncol: int,
    config: PlanConfig = PlanConfig(128, 128),
    backend: str = "auto",
    with_transpose: bool = False,
) -> Grid2DPlan:
    """Pad the graph to R * C window-aligned node blocks and preprocess
    each rank's rectangular block A[rows_i, cols_j] with column ids local
    to the all-gather over "row" (source block i' * C + j maps to local
    rows [i' * shard, (i' + 1) * shard))."""
    shard = pad_rows(num_nodes, nrow * ncol, config.block_h)
    a_pad = padded_csr(indptr, indices, num_nodes, shard * nrow * ncol)

    plans, tplans = {}, {}
    for i in range(nrow):
        rows = a_pad[i * ncol * shard: (i + 1) * ncol * shard]
        for j in range(ncol):
            # the union of node blocks {i' * C + j} in gather order (i'
            # ascending): local col = i' * shard + o
            col_sel = np.concatenate([
                np.arange((ip * ncol + j) * shard, (ip * ncol + j + 1) * shard, dtype=np.int64)
                for ip in range(nrow)])
            blk = rows[:, col_sel].tocsr()
            plans[(i, j)] = csr_preprocess(blk.indptr.astype(np.int64),
                                           blk.indices.astype(np.int64), ncol * shard, config,
                                           backend=backend, num_cols=nrow * shard)
            if with_transpose:
                tb = blk.T.tocsr()
                tplans[(i, j)] = csr_preprocess(tb.indptr.astype(np.int64),
                                                tb.indices.astype(np.int64), nrow * shard,
                                                config, backend=backend, num_cols=ncol * shard)

    bm, hi, wob, bp, tb_max = _pad_stack_grid2d(plans, config, nrow, ncol)
    out = Grid2DPlan(bitmask=bm, hind=hi, window_of_block=wob, block_ptr=bp, config=config,
                     num_nodes=shard * nrow * ncol, shard=shard, tb_max=tb_max, nrow=nrow,
                     ncol=ncol)
    if with_transpose:
        (out.bitmask_t, out.hind_t, out.window_of_block_t, out.block_ptr_t,
         out.tbt_max) = _pad_stack_grid2d(tplans, config, nrow, ncol)
    return out


def _rect_spmm(plan, x: torch.Tensor) -> torch.Tensor:
    """One rank's rectangular block SpMM (K1 on the card)."""
    return spmm(plan, x)


def _grid2d_fwd(plan, row_group, col_group, x: torch.Tensor) -> torch.Tensor:
    # X[cols_j]: every mesh-row peer's chunk at THIS mesh column
    xg = comm.all_gather(x.contiguous(), row_group)
    # partial outputs for the whole mesh row; block i * C + j lands home
    return comm.psum_scatter(_rect_spmm(plan, xg), col_group).to(x.dtype)


def _grid2d_bwd(plan_t, row_group, col_group, g: torch.Tensor) -> torch.Tensor:
    # the mirror: dOut[rows_i] over "col", A_ij^T, dX[cols_j] shares
    # summed and scattered over "row"
    gg = comm.all_gather(g.to(torch.float32).contiguous(), col_group)
    return comm.psum_scatter(_rect_spmm(plan_t, gg), row_group).to(g.dtype)


class _Grid2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, plan_t, row_group, col_group):
        ctx.plan_t, ctx.groups = plan_t, (row_group, col_group)
        return _grid2d_fwd(plan, row_group, col_group, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.plan_t is None:
            raise ValueError("build_grid2d_plan(..., with_transpose=True) required for the "
                             "grid2d backward")
        return _grid2d_bwd(ctx.plan_t, *ctx.groups, g), None, None, None, None


def _setup(plan: Grid2DPlan, mesh, row_axis, col_axis, what):
    """(row group, col group, i, j) of this rank."""
    row_group = comm.axis_group(mesh, row_axis)
    col_group = comm.axis_group(mesh, col_axis)
    shape = (dist.get_world_size(row_group), dist.get_world_size(col_group))
    if shape != (plan.nrow, plan.ncol):
        raise ValueError(f"{what}: the mesh is {shape[0]} x {shape[1]}, the plan "
                         f"{plan.nrow} x {plan.ncol}")
    return row_group, col_group, dist.get_rank(row_group), dist.get_rank(col_group)


def grid2d_spmm(plan: Grid2DPlan, feat: torch.Tensor, mesh, row_axis="row",
                col_axis="col") -> torch.Tensor:
    """This rank's rows of A @ X on a (row_axis, col_axis) mesh: `feat` is
    node block i * C + j's (shard, D) rows of X (`plan.rows_of(x, i * C +
    j)`). One all-gather over "row" and one reduce-scatter over "col";
    differentiable when the plan has its transpose blocks."""
    check_rows(feat, plan.shard, "grid2d_spmm")
    row_group, col_group, i, j = _setup(plan, mesh, row_axis, col_axis, "grid2d_spmm")
    fwd, bwd = plan.local(i, j, feat.device)
    return _Grid2D.apply(feat, fwd, bwd, row_group, col_group)


def make_grid2d_train_step(plan: Grid2DPlan, mesh, inv_deg, lr: float = 1e-2, row_axis="row",
                           col_axis="col", device=None) -> FullGraphStep:
    """Full-graph GCN training step over the 2D-partitioned SpMM. The
    contract of `make_ring_train_step`, with this rank's rows
    `plan.rows_of(x, i * C + j)`: both aggregation layers pay one
    all-gather over "row" and one reduce-scatter over "col" forward, and
    the mirrored pair backward."""
    if plan.tbt_max == 0:
        raise ValueError("build_grid2d_plan(..., with_transpose=True) required for training")
    row_group, col_group, i, j = _setup(plan, mesh, row_axis, col_axis,
                                        "make_grid2d_train_step")
    device = comm.rank_device(device)
    fwd, bwd = plan.local(i, j, device)
    index = i * plan.ncol + j
    return FullGraphStep(
        lambda h: _Grid2D.apply(h, fwd, bwd, row_group, col_group),
        local_inv_deg(plan, inv_deg, index, device), plan.shard, lr,
        comm.axis_group(mesh, (row_axis, col_axis)), "make_grid2d_train_step")

"""Ring-overlapped row-sharded SpMM (counterpart of
voltrix_spmm_tpu/parallel/ring.py).

`row_sharded_spmm` all-gathers X up front, so the transfer and the local
SpMM serialize. Here A is cut into an ndev x ndev grid of blocks by row
and column shard, and X travels a ring: at step t each rank multiplies its
(rows_dev x cols_src) block with the chunk it holds (K1 on the card) while
the next chunk is in flight, its send and receive posted before the
block's SpMM.

The op is linear in X, so its backward needs no residual: the forward
ring is an all-gather ring, its transpose a reduce-scatter ring over the
transpose blocks, both in one autograd.Function.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..format.plan import PlanConfig
from ..format.preprocess import csr_preprocess
from ..ops import spmm
from . import comm
from .row_sharded import check_group, check_rows, device_plan, pad_rows, plan_arrays
from .row_sharded_gcn import FullGraphStep, local_inv_deg


@dataclass
class RingShardedPlan:
    """ndev x ndev grid of (rows_dev x cols_src) block plans, padded to a
    common block count."""

    bitmask: np.ndarray  # uint32 (ndev, ndev, tb, words, K)
    hind: np.ndarray  # int32 (ndev, ndev, tb, K): shard-relative column ids
    window_of_block: np.ndarray  # int32 (ndev, ndev, tb)
    block_ptr: np.ndarray  # int32 (ndev, ndev, windows + 1)
    config: PlanConfig
    num_nodes: int  # padded global rows (= ndev * shard_rows)
    shard_rows: int
    tb_max: int
    ndev: int
    # transpose blocks A[dev, src]^T for the backward ring
    bitmask_t: np.ndarray | None = None
    hind_t: np.ndarray | None = None
    window_of_block_t: np.ndarray | None = None
    block_ptr_t: np.ndarray | None = None
    tbt_max: int = 0
    _local: dict = field(default_factory=dict, repr=False, compare=False)

    def local(self, index: int, device):
        """(block plans, transpose block plans or None) of grid row
        `index`, each a list indexed by the source shard, moved to
        `device` at the first call and kept."""
        key = (index, str(device))
        if key not in self._local:
            s, n = self.shard_rows, self.ndev

            def row(bm, hi, wob, bp, tb):
                return [device_plan(bm[index, src], hi[index, src], wob[index, src],
                                    bp[index, src], self.config, s, s, tb, device)
                        for src in range(n)]

            fwd = row(self.bitmask, self.hind, self.window_of_block, self.block_ptr,
                      self.tb_max)
            bwd = None
            if self.bitmask_t is not None:
                bwd = row(self.bitmask_t, self.hind_t, self.window_of_block_t,
                          self.block_ptr_t, self.tbt_max)
            self._local[key] = (fwd, bwd)
        return self._local[key]

    def rows_of(self, x, index: int):
        """Shard `index`'s rows of the padded global array `x`."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"x has {x.shape[0]} rows, the plan {self.num_nodes}")
        return x[index * self.shard_rows: (index + 1) * self.shard_rows]

    def assemble(self, shards):
        """The (num_nodes, ...) array of every shard's rows, in shard order."""
        return np.concatenate([np.asarray(s) for s in shards])


def _pad_stack_grid(plans, config, ndev):
    """(ndev * ndev plans, row-major) -> stacked arrays padded to tb_max."""
    tb_max = max(max(p.total_blocks for p in plans), 1)
    words, K = config.words_per_col, config.block_w
    nw = plans[0].num_windows
    bm = np.zeros((ndev, ndev, tb_max, words, K), np.uint32)
    hi = np.zeros((ndev, ndev, tb_max, K), np.int32)
    wob = np.zeros((ndev, ndev, tb_max), np.int32)
    bp = np.zeros((ndev, ndev, nw + 1), np.int32)
    for i, p in enumerate(plans):
        d, s = divmod(i, ndev)
        t = p.total_blocks
        a_bm, a_hi, a_wob, a_bp = plan_arrays(p)
        bm[d, s, :t] = a_bm
        hi[d, s, :t] = a_hi
        wob[d, s, :t] = a_wob
        wob[d, s, t:] = p.num_windows - 1  # padding accumulates zeros
        bp[d, s, :-1] = a_bp[:-1]
        bp[d, s, -1] = tb_max
    return bm, hi, wob, bp, tb_max


def padded_csr(indptr, indices, num_nodes: int, n_pad: int):
    """A as a scipy CSR padded with empty rows and columns to n_pad x n_pad."""
    import scipy.sparse as sp

    a = sp.csr_matrix(
        (np.ones(np.asarray(indices).shape[0], np.float32), np.asarray(indices, np.int64),
         np.asarray(indptr, np.int64)),
        shape=(num_nodes, num_nodes),
    )
    a_pad = sp.vstack([a, sp.csr_matrix((n_pad - num_nodes, num_nodes), dtype=np.float32)])
    return sp.hstack([a_pad, sp.csr_matrix((n_pad, n_pad - num_nodes), dtype=np.float32)]).tocsr()


def build_ring_sharded_plan(
    indptr,
    indices,
    num_nodes: int,
    ndev: int,
    config: PlanConfig = PlanConfig(128, 128),
    backend: str = "auto",
    with_transpose: bool = False,
) -> RingShardedPlan:
    """Partition A into an ndev x ndev block grid (contiguous row and
    column ranges) and preprocess each block with shard-relative column
    ids (they index the travelling chunk, not global X)."""
    shard_rows = pad_rows(num_nodes, ndev, config.block_h)
    a_pad = padded_csr(indptr, indices, num_nodes, shard_rows * ndev)

    plans, tplans = [], []
    for d in range(ndev):
        rblk = a_pad[d * shard_rows: (d + 1) * shard_rows]
        for s in range(ndev):
            blk = rblk[:, s * shard_rows: (s + 1) * shard_rows].tocsr()
            plans.append(csr_preprocess(blk.indptr.astype(np.int64), blk.indices.astype(np.int64),
                                        shard_rows, config, backend=backend,
                                        num_cols=shard_rows))
            if with_transpose:
                tb = blk.T.tocsr()
                tplans.append(csr_preprocess(tb.indptr.astype(np.int64),
                                             tb.indices.astype(np.int64), shard_rows, config,
                                             backend=backend, num_cols=shard_rows))

    bm, hi, wob, bp, tb_max = _pad_stack_grid(plans, config, ndev)
    out = RingShardedPlan(bitmask=bm, hind=hi, window_of_block=wob, block_ptr=bp, config=config,
                          num_nodes=shard_rows * ndev, shard_rows=shard_rows, tb_max=tb_max,
                          ndev=ndev)
    if with_transpose:
        (out.bitmask_t, out.hind_t, out.window_of_block_t, out.block_ptr_t,
         out.tbt_max) = _pad_stack_grid(tplans, config, ndev)
    return out


def _block_spmm(plans, src: int, x_chunk: torch.Tensor) -> torch.Tensor:
    """One (rows_dev x cols_src) block SpMM: `plans` is this rank's row of
    block plans (`RingShardedPlan.local`), indexed by the source shard."""
    return spmm(plans[src], x_chunk)


def _ring_fwd(plans, group, x: torch.Tensor) -> torch.Tensor:
    n, dev = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    chunk, out = x.contiguous(), None
    for t in range(n):
        # the next chunk in flight while this block multiplies
        pending = comm.ppermute(chunk, group, 1) if t + 1 < n else None
        part = _block_spmm(plans, (dev - t) % n, chunk)
        out = part if out is None else out + part
        if pending is not None:
            chunk = pending.wait()
    return out.to(x.dtype)


def _ring_bwd(plans_t, group, g: torch.Tensor) -> torch.Tensor:
    """The reduce-scatter ring: the accumulator for target shard src visits
    every rank once and lands home. At step t rank dev holds the one
    destined for src = dev + 1 + t (mod n) and adds A[dev, src]^T @ g_dev,
    computed while the accumulator travels."""
    n, dev = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    g32 = g.to(torch.float32).contiguous()
    acc = _block_spmm(plans_t, (dev + 1) % n, g32)
    for t in range(1, n):
        pending = comm.ppermute(acc, group, -1)
        part = _block_spmm(plans_t, (dev + 1 + t) % n, g32)
        acc = pending.wait() + part
    return acc.to(g.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plans, plans_t, group):
        ctx.plans_t, ctx.group = plans_t, group
        return _ring_fwd(plans, group, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.plans_t is None:
            raise ValueError("build_ring_sharded_plan(..., with_transpose=True) "
                             "required for the backward ring")
        return _ring_bwd(ctx.plans_t, ctx.group, g), None, None, None


def ring_sharded_spmm(plan: RingShardedPlan, feat: torch.Tensor, mesh,
                      axis="data") -> torch.Tensor:
    """This rank's rows of A @ X: `feat` is its (shard_rows, D) rows of X
    (`plan.rows_of(x, index)`, index = `comm.shard_index(mesh, axis)`).
    ndev - 1 ring shifts, each in flight during a block SpMM (K1 on the
    card); differentiable when the plan has its transpose blocks."""
    check_rows(feat, plan.shard_rows, "ring_sharded_spmm")
    group = comm.axis_group(mesh, axis)
    plans, plans_t = plan.local(check_group(plan, group, "ring_sharded_spmm"), feat.device)
    return _Ring.apply(feat, plans, plans_t, group)


def make_ring_train_step(plan: RingShardedPlan, mesh, inv_deg, lr: float = 1e-2, axis="data",
                         device=None) -> FullGraphStep:
    """Full-graph GCN training step over the ring SpMM: each of the two
    aggregation layers runs the ring forward and, through its
    autograd.Function, the reduce-scatter ring backward. The contract of
    `make_row_sharded_train_step`: step(params, x, y) -> (params, loss) on
    this rank's rows (`plan.rows_of`), label -100 excluding a row."""
    if plan.tbt_max == 0:
        raise ValueError("build_ring_sharded_plan(..., with_transpose=True) required for "
                         "training (the backward runs the transpose-plan ring)")
    group = comm.axis_group(mesh, axis)
    index = check_group(plan, group, "make_ring_train_step")
    device = comm.rank_device(device)
    plans, plans_t = plan.local(index, device)
    invd = local_inv_deg(plan, inv_deg, index, device)
    return FullGraphStep(lambda h: _Ring.apply(h, plans, plans_t, group), invd, plan.shard_rows,
                         lr, group, "make_ring_train_step")


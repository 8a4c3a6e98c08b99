"""Row-sharded (graph-partitioned) SpMM across ranks (counterpart of
voltrix_spmm_tpu/parallel/row_sharded.py).

Each rank owns a window-aligned range of A's rows (and of X's), all-gathers
X from the group before its local SpMM (kernel K1 on the card) and keeps
its output rows: the one collective a partitioned binary SpMM needs.

Per-rank plans have different block counts; they are built per shard and
stacked with padding to the largest (padding blocks carry zero bits and
attach to the last window), as numpy arrays equal bit for bit to the JAX
package's. A rank moves only its own slice to its device, once
(`RowShardedPlan.local`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..format.plan import PlanConfig, SpmmPlan
from ..format.preprocess import csr_preprocess
from ..ops import spmm
from . import comm


def plan_arrays(plan: SpmmPlan):
    """(bitmask as uint32, hind, window_of_block, block_ptr) of a CPU plan
    as numpy arrays, in the JAX package's dtypes."""
    return (plan.bitmask.numpy().view(np.uint32), plan.hind.numpy(),
            plan.window_of_block.numpy(), plan.block_ptr.numpy())


def device_plan(bm, hi, wob, bp, config: PlanConfig, rows: int, cols: int, tb: int,
                device) -> SpmmPlan:
    """One stacked slice as an SpmmPlan on `device`: `rows` output rows over
    `cols` source rows, tb blocks (padding included), empty windows
    allowed."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(device)

    return SpmmPlan(
        bitmask=put(bm, np.int32), hind=put(hi, np.int32), window_of_block=put(wob, np.int32),
        block_ptr=put(bp, np.int32), config=config, num_nodes=rows, num_edges=0,
        num_windows=rows // config.block_h, total_blocks=tb, has_empty_windows=True,
        num_cols=cols)


def pad_rows(num_nodes: int, ndev: int, block_h: int) -> int:
    """Rows per shard: num_nodes over ndev, rounded up to whole windows."""
    return -(-num_nodes // (ndev * block_h)) * block_h


@dataclass
class RowShardedPlan:
    # stacked per-rank plan arrays, leading dim = ranks
    bitmask: np.ndarray  # uint32 (ndev, tb_max, words, K)
    hind: np.ndarray  # int32 (ndev, tb_max, K)
    window_of_block: np.ndarray  # int32 (ndev, tb_max)
    block_ptr: np.ndarray  # int32 (ndev, windows_per_shard + 1)
    config: PlanConfig
    num_nodes: int  # global (padded to ndev * shard_rows)
    shard_rows: int  # nodes per rank
    tb_max: int
    ndev: int
    # transpose plans (A[rows_s, :]^T per shard) for training: the
    # backward of the local SpMM is another SpMM with these (see spmm_ad)
    bitmask_t: np.ndarray | None = None  # (ndev, tbt_max, words, K)
    hind_t: np.ndarray | None = None  # (ndev, tbt_max, K)
    window_of_block_t: np.ndarray | None = None  # (ndev, tbt_max)
    block_ptr_t: np.ndarray | None = None  # (ndev, global_windows + 1)
    tbt_max: int = 0
    # degree-balanced assignment: row_perm[k] = original row owning the
    # k-th padded output position (None = contiguous ranges)
    row_perm: np.ndarray | None = None
    _local: dict = field(default_factory=dict, repr=False, compare=False)

    def local(self, index: int, device):
        """(plan, transpose plan or None) of shard `index` on `device`,
        moved there at the first call and kept: a trainer commits its
        shard once, not per step."""
        key = (index, str(device))
        if key not in self._local:
            cfg, s = self.config, self.shard_rows
            fwd = device_plan(self.bitmask[index], self.hind[index],
                              self.window_of_block[index], self.block_ptr[index], cfg, s,
                              self.num_nodes, self.tb_max, device)
            bwd = None
            if self.bitmask_t is not None:
                bwd = device_plan(self.bitmask_t[index], self.hind_t[index],
                                  self.window_of_block_t[index], self.block_ptr_t[index], cfg,
                                  self.num_nodes, s, self.tbt_max, device)
            self._local[key] = (fwd, bwd)
        return self._local[key]

    def rows_of(self, x, index: int):
        """Shard `index`'s rows of the padded global array `x` (num_nodes
        rows) in the plan's layout: permuted by row_perm for a balanced
        plan (the "permute in" of the JAX package's row_sharded_spmm)."""
        if x.shape[0] != self.num_nodes:
            raise ValueError(f"x has {x.shape[0]} rows, the plan {self.num_nodes}")
        lo, hi = index * self.shard_rows, (index + 1) * self.shard_rows
        return x[lo:hi] if self.row_perm is None else x[self.row_perm[lo:hi]]

    def assemble(self, shards):
        """The (num_nodes, ...) array of every shard's rows (a list in
        shard order) in the original row order: the "scatter back" of the
        JAX package's row_sharded_spmm."""
        stacked = np.concatenate([np.asarray(s) for s in shards])
        if self.row_perm is None:
            return stacked
        out = np.zeros_like(stacked)
        out[self.row_perm] = stacked
        return out


def _pad_stack_plans(plans, config, ndev):
    """Stack per-shard SpmmPlans into one set, padded to the max block
    count (padding blocks carry zero bits and attach to the last window)."""
    tb_max = max(max(p.total_blocks for p in plans), 1)
    words, K = config.words_per_col, config.block_w
    arrays = [plan_arrays(p) for p in plans]

    def pad_stack(i, shape_tail, dtype):
        out = np.zeros((ndev, tb_max, *shape_tail), dtype=dtype)
        for r, arr in enumerate(arrays):
            out[r, : arr[i].shape[0]] = arr[i]
        return out

    bitmask = pad_stack(0, (words, K), np.uint32)
    hind = pad_stack(1, (K,), np.int32)
    wob = np.zeros((ndev, tb_max), dtype=np.int32)
    for r, (p, arr) in enumerate(zip(plans, arrays)):
        wob[r, : arr[2].shape[0]] = arr[2]
        wob[r, arr[2].shape[0]:] = p.num_windows - 1
    bptr = np.stack(
        [np.concatenate([arr[3][:-1], np.array([tb_max], dtype=np.int32)]) for arr in arrays]
    ).astype(np.int32)
    return bitmask, hind, wob, bptr, tb_max


def build_row_sharded_plan(
    indptr,
    indices,
    num_nodes: int,
    ndev: int,
    config: PlanConfig = PlanConfig(128, 128),
    backend: str = "auto",
    with_transpose: bool = False,
    balance: bool = False,
) -> RowShardedPlan:
    """Partition rows into `ndev` shards and build one padded plan per
    shard (the port's csr_preprocess). Columns (neighbour ids) stay global.

    with_transpose=True also builds each shard's A[rows_s, :]^T plan
    (global rows x shard columns), which training needs.

    balance=True assigns rows round-robin by degree rank instead of
    contiguous ranges, equalizing per-shard edge counts on skewed graphs.
    The whole plan then lives in permuted padded-position space: row k of
    the stacked layout is original row `row_perm[k]`, and column ids are
    remapped through the inverse permutation so they index the
    all-gathered activations in that same layout (`rows_of` permutes in,
    `assemble` scatters back; the trainer keeps activations permuted end
    to end)."""
    import scipy.sparse as sp

    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    shard_rows = pad_rows(num_nodes, ndev, config.block_h)
    n_pad = shard_rows * ndev

    if balance:
        deg = np.diff(indptr)
        order = np.argsort(-deg, kind="stable")
        shard_rows_list = [np.sort(order[dev::ndev]) for dev in range(ndev)]
        # padding slots map to the unused padded ids [num_nodes, n_pad) so
        # the scatter-back never collides with a real row
        row_perm = np.full(n_pad, -1, dtype=np.int32)
        for dev, mine in enumerate(shard_rows_list):
            row_perm[dev * shard_rows: dev * shard_rows + mine.shape[0]] = mine
        pad_slots = row_perm < 0
        row_perm[pad_slots] = np.arange(num_nodes, num_nodes + int(pad_slots.sum()),
                                        dtype=np.int32)
        # padded position of each original (or pad) id: the column remap
        pos_of = np.empty(n_pad, dtype=np.int64)
        pos_of[row_perm.astype(np.int64)] = np.arange(n_pad, dtype=np.int64)
    else:
        row_perm = None

    a_full = sp.csr_matrix(
        (np.ones(indices.shape[0], np.float32), indices, indptr),
        shape=(num_nodes, num_nodes),
    )

    plans: list[SpmmPlan] = []
    tplans: list[SpmmPlan] = []
    for dev in range(ndev):
        if balance:
            mine = shard_rows_list[dev]
            a_s = a_full[mine]
            local_ptr = np.zeros(shard_rows + 1, dtype=np.int64)
            local_ptr[1: mine.shape[0] + 1] = a_s.indptr[1:]
            local_ptr[mine.shape[0] + 1:] = a_s.indptr[-1]
            local_idx = pos_of[a_s.indices.astype(np.int64)]
        else:
            r0 = min(dev * shard_rows, num_nodes)
            r1 = min(r0 + shard_rows, num_nodes)
            local_ptr = np.zeros(shard_rows + 1, dtype=np.int64)
            seg = indptr[r0: r1 + 1] - indptr[r0]
            local_ptr[: seg.shape[0]] = seg
            local_ptr[seg.shape[0]:] = seg[-1] if seg.shape[0] else 0
            local_idx = indices[indptr[r0]: indptr[r1]]
        # local CSR over shard_rows rows; columns stay GLOBAL ids (they
        # index the all-gathered X): original node ids for the contiguous
        # split, permuted padded positions when balance=True
        plans.append(csr_preprocess(local_ptr, local_idx, shard_rows, config, backend=backend,
                                    num_cols=n_pad if balance else num_nodes))
        if with_transpose:
            a_s2 = sp.csr_matrix(
                (np.ones(local_idx.shape[0], np.float32), local_idx, local_ptr),
                shape=(shard_rows, n_pad),
            )
            at = a_s2.T.tocsr()  # (n_pad, shard_rows)
            tplans.append(csr_preprocess(at.indptr, at.indices, n_pad, config, backend=backend,
                                         num_cols=shard_rows))

    bitmask, hind, wob, bptr, tb_max = _pad_stack_plans(plans, config, ndev)
    out = RowShardedPlan(bitmask=bitmask, hind=hind, window_of_block=wob, block_ptr=bptr,
                         config=config, num_nodes=n_pad, shard_rows=shard_rows, tb_max=tb_max,
                         ndev=ndev, row_perm=row_perm)
    if with_transpose:
        (out.bitmask_t, out.hind_t, out.window_of_block_t, out.block_ptr_t,
         out.tbt_max) = _pad_stack_plans(tplans, config, ndev)
    return out


def check_group(plan, group, what: str) -> int:
    """This rank's shard index in `group`; raises if the group's size is
    not the plan's shard count."""
    import torch.distributed as dist

    if dist.get_world_size(group) != plan.ndev:
        raise ValueError(f"{what}: the plan has {plan.ndev} shards, the axis "
                         f"{dist.get_world_size(group)} ranks")
    return dist.get_rank(group)


def check_rows(x: torch.Tensor, rows: int, what: str) -> None:
    """The JAX package's `assert n == plan.num_nodes` of each *_spmm, as a
    ValueError: here `x` holds this rank's `rows` rows."""
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{what}: x must be this rank's ({rows}, D) rows of the plan, "
                         f"got {tuple(x.shape)}")


def row_sharded_spmm(plan: RowShardedPlan, feat: torch.Tensor, mesh, axis="data") -> torch.Tensor:
    """This rank's rows of A @ X: `feat` is its (shard_rows, D) rows of X in
    the plan's layout (`plan.rows_of(x, index)`, index = `comm.shard_index
    (mesh, axis)`); the result, its rows of the output in the same layout
    (`plan.assemble` of every rank's result is A @ x in the original
    order). One all-gather of X over `axis`; the SpMM itself is local, K1
    on the card."""
    check_rows(feat, plan.shard_rows, "row_sharded_spmm")
    group = comm.axis_group(mesh, axis)
    index = check_group(plan, group, "row_sharded_spmm")
    local_plan, _ = plan.local(index, feat.device)
    return spmm(local_plan, comm.all_gather(feat, group))

"""Neighbour-sampled mini-batch blocks, the GraphSAGE training protocol
(counterpart of voltrix_spmm_tpu/data/sampling.py).

Per batch of seed nodes, each hop samples at most `fanout` neighbours of
each destination node and builds the sampled bipartite adjacency as a
rectangular plan (num_dst rows gathering from num_src source rows) and
its transpose. Both are padded to capacities that depend only on the
batch geometry (seed count, fanouts, PlanConfig): source lists to
num_dst * (fanout + 1) slots, plans to the closed-form `block_caps`. So
every batch of a geometry has the same shapes, and the plans equal the
JAX package's bit for bit from the same numpy seed, padding included:
zero-bitmask blocks in the last window, -1 source slots.

The plans are built on the host (torch tensors on the CPU);
`models.sage_minibatch.blocks_args` moves to the card only the plans a
step launches. The deepest hop's transpose plan is the largest array of
a batch and is read only by the gradient of the raw features, which
needs none, so it stays on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..format.plan import PlanConfig, SpmmPlan
from ..format.preprocess import csr_preprocess


def _pad_plan_blocks(plan: SpmmPlan, cap: int, edge_cap: int) -> SpmmPlan:
    """The plan with its blocks padded to `cap` by zero-bitmask blocks in
    the last window (hind 0, window_of_block the last window, block_ptr[-1]
    = cap), and the batch-dependent fields set from the geometry
    (num_edges = edge_cap, has_empty_windows = True), as the JAX package
    pads them. The padding is allocated by numpy, whose zeros the OS
    hands over lazily: pages no one reads are never touched."""
    t = plan.total_blocks
    if t > cap:
        raise ValueError(f"plan has {t} blocks, more than its cap {cap}")
    words, k = plan.config.words_per_col, plan.config.block_w
    bm = np.zeros((cap, words, k), np.int32)
    bm[:t] = plan.bitmask.numpy()
    hi = np.zeros((cap, k), np.int32)
    hi[:t] = plan.hind.numpy()
    wob = np.full((cap,), plan.num_windows - 1, np.int32)
    wob[:t] = plan.window_of_block.numpy()
    bp = plan.block_ptr.clone()
    bp[-1] = cap
    return dataclasses.replace(
        plan,
        bitmask=torch.from_numpy(bm),
        hind=torch.from_numpy(hi),
        window_of_block=torch.from_numpy(wob),
        block_ptr=bp,
        total_blocks=cap,
        num_edges=edge_cap,
        has_empty_windows=True,
    )


def block_caps(num_dst: int, num_src: int, fanout: int, config: PlanConfig) -> tuple[int, int]:
    """Closed-form block caps of a sampled block and its transpose: a
    window of block_h dst rows reaches at most block_h * fanout distinct
    sources (and never more than num_src); a window of source rows at most
    num_dst distinct columns."""
    h, w = config.block_h, config.block_w
    nwin = -(-num_dst // h)
    cap_f = max(nwin * (-(-min(h * fanout, num_src) // w)), 1)
    nwin_t = -(-num_src // h)
    cap_t = max(nwin_t * (-(-num_dst // w)), 1)
    return cap_f, cap_t


@dataclass
class SampleBlock:
    """One sampled hop: dst rows aggregate from src rows. Source slot j <
    num_dst is dst j itself (self features = h[:num_dst]); padding slots
    carry src_ids == -1."""

    plan: SpmmPlan  # (num_dst x num_src) sampled adjacency, on the host
    plan_t: SpmmPlan  # its transpose, for the backward SpMM, on the host
    inv_deg: np.ndarray  # float32 (num_dst, 1): 1 / max(sampled degree, 1)
    src_ids: np.ndarray  # int32 (num_src,) global ids, -1 = padding
    num_dst: int
    num_src: int


def _sample_edges(indptr, indices, dst_ids, fanout: int, rng: np.random.Generator):
    """The sampling half of `sample_block`: (rows, cols, src_ids int64,
    inv_deg). Each dst node with more than `fanout` neighbours draws
    rng.choice(deg, fanout, replace=False), node by node in dst order, as
    the JAX package does, so `rng` gives the same picks and ends in the
    same state. A neighbour not yet in the source list takes the next slot
    in the order of its first appearance (the JAX package's dict lookups,
    done here with one np.unique)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    dst_ids = np.asarray(dst_ids, np.int64)
    num_dst = len(dst_ids)
    inv_deg = np.ones((num_dst, 1), np.float32)
    rows, nbs = [], []
    for i, gid in enumerate(dst_ids):
        if gid < 0:
            continue
        lo, hi = int(indptr[gid]), int(indptr[gid + 1])
        deg = hi - lo
        if deg == 0:
            continue
        k = min(fanout, deg)
        sel = np.arange(deg) if deg <= fanout else rng.choice(deg, size=k, replace=False)
        inv_deg[i, 0] = 1.0 / k
        nbs.append(indices[lo:hi][sel])
        rows.append(np.full(k, i, np.int64))
    nb = np.concatenate(nbs).astype(np.int64) if nbs else np.zeros(0, np.int64)
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)

    src_ids = np.full(num_dst * (fanout + 1), -1, np.int64)
    src_ids[:num_dst] = dst_ids
    # the dst ids hold slots 0..num_dst-1, a repeated id its first slot
    valid = np.flatnonzero(dst_ids >= 0)
    known, first = np.unique(dst_ids[valid], return_index=True)
    known_slot = valid[first]
    pos = np.minimum(np.searchsorted(known, nb), max(len(known) - 1, 0))
    is_known = (known[pos] == nb) if len(known) else np.zeros(len(nb), bool)
    cols = np.empty(len(nb), np.int64)
    cols[is_known] = known_slot[pos[is_known]]
    # the others take new slots in the order of their first appearance
    fresh = nb[~is_known]
    new_ids, first_at, inverse = np.unique(fresh, return_index=True, return_inverse=True)
    rank = np.empty(len(new_ids), np.int64)
    rank[np.argsort(first_at, kind="stable")] = np.arange(len(new_ids))
    cols[~is_known] = num_dst + rank[inverse.reshape(-1)]
    src_ids[num_dst + rank] = new_ids
    return rows, cols, src_ids, inv_deg


def _block_plans(rows, cols, src_ids, inv_deg, fanout: int, config: PlanConfig) -> SampleBlock:
    """The plan-building half of `sample_block`: the sampled CSR, its
    transpose, both plans, both padded to `block_caps`."""
    import scipy.sparse as sp

    num_dst = inv_deg.shape[0]
    num_src = num_dst * (fanout + 1)
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(num_dst, num_src))
    a.sum_duplicates()
    at = a.T.tocsr()
    cap_f, cap_t = block_caps(num_dst, num_src, fanout, config)
    edge_cap = num_dst * fanout
    plan = _pad_plan_blocks(
        csr_preprocess(a.indptr, a.indices, num_dst, config, num_cols=num_src), cap_f, edge_cap)
    plan_t = _pad_plan_blocks(
        csr_preprocess(at.indptr, at.indices, num_src, config, num_cols=num_dst), cap_t, edge_cap)
    return SampleBlock(plan=plan, plan_t=plan_t, inv_deg=inv_deg,
                       src_ids=src_ids.astype(np.int32), num_dst=num_dst, num_src=num_src)


def sample_block(indptr, indices, dst_ids: np.ndarray, fanout: int, rng: np.random.Generator,
                 config: PlanConfig = PlanConfig(32, 128)) -> SampleBlock:
    """Sample at most `fanout` distinct neighbours of each dst node (without
    replacement) and build the padded rectangular plans. dst_ids may hold
    -1 padding rows, which sample nothing."""
    return _block_plans(*_sample_edges(indptr, indices, dst_ids, fanout, rng), fanout, config)


def sample_blocks(indptr, indices, seeds: np.ndarray, fanouts: list[int],
                  rng: np.random.Generator,
                  config: PlanConfig = PlanConfig(32, 128)) -> list[SampleBlock]:
    """Layered sampling: fanouts[-1] samples the seed hop, fanouts[0] the
    deepest. Returns the blocks input side first (blocks[0] reads the raw
    features, blocks[-1] emits the seed rows); each hop's dst list is the
    previous hop's whole padded source list."""
    blocks: list[SampleBlock] = []
    dst = np.asarray(seeds, np.int64)
    for f in reversed(fanouts):
        blk = sample_block(indptr, indices, dst, f, rng, config)
        blocks.append(blk)
        dst = blk.src_ids.astype(np.int64)
    return list(reversed(blocks))


def gather_features(x, src_ids):
    """Feature rows of a padded source list, -1 slots as zeros: a numpy
    array gives numpy (the JAX package's arithmetic), a tensor a tensor on
    its own device (ids of either kind)."""
    if isinstance(x, torch.Tensor):
        if not isinstance(src_ids, torch.Tensor):
            src_ids = torch.from_numpy(np.asarray(src_ids))
        ids = src_ids.to(device=x.device, dtype=torch.int64)
        out = x.index_select(0, ids.clamp(0, x.shape[0] - 1))
        return torch.where((ids >= 0)[:, None], out, 0.0)
    x = np.asarray(x)
    ids = np.asarray(src_ids)
    out = x[np.clip(ids, 0, x.shape[0] - 1)]
    return np.where((ids >= 0)[:, None], out, 0.0).astype(x.dtype)

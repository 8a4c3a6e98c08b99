"""Tuple-style API in the reference Voltrix call shapes (counterpart of
voltrix_spmm_tpu/compat.py):

    blk_offsets, hspa_packed, hind = csr_preprocess_tuple(indptr, indices, num_nodes)
    out = spmm_tuple(blk_offsets, hspa_packed, hind, num_nodes, num_edges, feat)

on top of the plan-object API: `blk_offsets` is the block prefix per
window (the plan's block_ptr), `hspa_packed` the bitmask (int32 words
carrying the uint32 bits), `hind` the gather map. The plan rides on the
returned `blk_offsets` tensor itself, so it lives exactly as long as that
tensor; arrays from elsewhere are rebuilt into a plan.
"""

from __future__ import annotations

import numpy as np
import torch

from .format.plan import PlanConfig, SpmmPlan
from .format.preprocess import csr_preprocess as _csr_preprocess
from .ops import spmm as _spmm

# default tile geometry: the plan's default window and block
BLK_H = PlanConfig().block_h
BLK_W = PlanConfig().block_w


def csr_preprocess_tuple(indptr, indices, num_nodes: int, config=None, device="cuda"):
    """(blk_offsets, hspa_packed, hind) of the CSR's plan, on `device` (the
    card unless the caller asks for the CPU); blk_offsets carries the plan."""
    plan = _csr_preprocess(indptr, indices, num_nodes, config or PlanConfig()).to(device)
    blk_offsets = plan.block_ptr.view(-1)  # a tensor of its own, sharing block_ptr's memory
    blk_offsets._voltrix_plan = plan
    return blk_offsets, plan.bitmask, plan.hind


def _tensor(a, device, dtype) -> torch.Tensor:
    """`a` (a tensor, or an array-like; uint32 words as the int32 words
    carrying their bits) as a contiguous `dtype` tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        a = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
    return a.to(device=device, dtype=dtype).contiguous()


def spmm_tuple(blk_offsets, hspa_packed, hind, num_nodes, num_edges, feat):
    """out = A @ feat in the reference's signature. Arrays that did not come
    from `csr_preprocess_tuple` (loaded from disk, copied) are rebuilt into
    a plan on feat's device; the tuple does not carry block_h, which is
    taken as words * 32 and must agree with the window count, else
    ValueError."""
    plan = getattr(blk_offsets, "_voltrix_plan", None)
    if plan is None:
        dev = feat.device
        bitmask = _tensor(hspa_packed, dev, torch.int32)
        total_blocks, words, block_w = bitmask.shape
        block_h = words * 32
        bp = _tensor(blk_offsets, "cpu", torch.int64)
        num_windows = bp.shape[0] - 1
        # sub-32 block heights (words == 1 can mean 8, 16 or 32 rows) would be
        # mis-addressed: only a window count that agrees is sound
        if num_windows != -(-num_nodes // block_h):
            raise ValueError(
                f"cannot reconstruct plan geometry: {num_windows} windows is inconsistent "
                f"with block_h={block_h} over {num_nodes} nodes; pass arrays produced by "
                "csr_preprocess_tuple (same process) or use the plan-object API"
            )
        bpw = torch.diff(bp)
        plan = SpmmPlan(
            bitmask=bitmask,
            hind=_tensor(hind, dev, torch.int32).reshape(total_blocks, block_w),
            window_of_block=torch.repeat_interleave(
                torch.arange(num_windows, dtype=torch.int32), bpw).to(dev),
            block_ptr=bp.to(device=dev, dtype=torch.int32),
            config=PlanConfig(block_h, block_w),
            num_nodes=num_nodes,
            num_edges=num_edges,
            num_windows=num_windows,
            total_blocks=total_blocks,
            has_empty_windows=bool((bpw == 0).any()),
        )
    if plan.num_nodes != num_nodes:
        raise ValueError(f"the plan has {plan.num_nodes} nodes, not {num_nodes}")
    return _spmm(plan, feat)


__all__ = ["BLK_H", "BLK_W", "csr_preprocess_tuple", "spmm_tuple"]

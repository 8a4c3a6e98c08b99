"""Two-level windows: within-window column clustering (counterpart of
voltrix_spmm_tpu/format/cluster.py, host numpy, ported close to the
letter so both packages build the same plans bit for bit).

Within each window the packed lanes are re-sorted by their sub-window
signature (bit s set iff the lane has a bit in 128-row sub-window s), so
lanes whose bits live in the same sub-windows share blocks. Each block's
occupancy (`block_occupancy`) then has few bits, and kernel K2
(ops/subtile_spmm.py) skips the (block, sub-window) pairs whose bit is
clear. A lane permutation moves (hind, bitmask) pairs together: the
matrix the plan encodes, and so the SpMM result, is unchanged.

gather_segment q > 1 plans are sorted in run units of q lanes, so the
q-aligned runs that kernel K3 fetches survive the permutation intact.
Needs block_h % 128 == 0 (the sub-window unit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .plan import SpmmPlan

SUBWIN_ROWS = 128  # sub-window height = 4 bitmask words
_WORDS_PER_SUB = SUBWIN_ROWS // 32


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_np(bitmask) -> np.ndarray:
    """A bitmask (int32 tensor or uint32 array) as its uint32 words."""
    return np.ascontiguousarray(_host(bitmask)).view(np.uint32)


def lane_signatures(bitmask) -> np.ndarray:
    """(TB, words, K) -> int64 (TB, K): bit s set iff the lane has any
    bit in 128-row sub-window s."""
    bitmask = _bits_np(bitmask)
    tb, words, k = bitmask.shape
    nsub = words // _WORDS_PER_SUB
    if nsub * _WORDS_PER_SUB != words:
        raise ValueError(f"{words} words are not whole 128-row sub-windows")
    sub_any = bitmask.reshape(tb, nsub, _WORDS_PER_SUB, k).any(axis=2)  # (TB, nsub, K)
    weights = np.int64(1) << np.arange(nsub, dtype=np.int64)
    return (sub_any * weights[None, :, None]).sum(axis=1)


def cluster_window_columns(plan: SpmmPlan) -> SpmmPlan:
    """A plan with each window's lanes re-sorted by sub-window signature
    (empty lanes last, ties broken by column id for gather locality).
    With gather_segment q > 1, runs of q lanes move as units (run
    signature = OR of its lanes, key column = the run head)."""
    cfg = plan.config
    q = cfg.gather_segment
    if cfg.block_h % SUBWIN_ROWS:
        raise ValueError(f"clustering needs block_h % 128 == 0, got {cfg.block_h}")
    if plan.total_blocks == 0:
        return plan

    bm = _bits_np(plan.bitmask)
    hind = _host(plan.hind)
    tb, words, k = bm.shape

    sig_lane = lane_signatures(bm).reshape(-1)  # (TB*K,) lane-major
    nruns = tb * k // q
    sig = np.bitwise_or.reduce(sig_lane.reshape(nruns, q), axis=1)
    col = hind.reshape(nruns, q)[:, 0].astype(np.int64)
    # a window's blocks are contiguous, and K % q == 0, so a window's runs
    # are contiguous in flat (block, lane) order
    run_win = np.repeat(_host(plan.window_of_block), k // q).astype(np.int64)
    empty = sig == 0  # padding runs -> window tail -> skippable blocks
    order = np.lexsort((col, sig, empty, run_win))
    lane_order = (order[:, None] * q + np.arange(q, dtype=order.dtype)[None, :]).reshape(-1)

    new_hind = np.ascontiguousarray(hind.reshape(-1)[lane_order].reshape(tb, k))
    lanes = bm.transpose(0, 2, 1).reshape(tb * k, words)
    new_bm = np.ascontiguousarray(lanes[lane_order].reshape(tb, k, words).transpose(0, 2, 1))
    return dataclasses.replace(
        plan,
        bitmask=torch.from_numpy(new_bm.view(np.int32)),
        hind=torch.from_numpy(new_hind),
    )


def block_occupancy(bitmask) -> np.ndarray:
    """(TB, words, K) -> int32 (TB,) carrying uint32 bits: bit s set iff
    128-row sub-window s of the block holds any bit (K2's skip bitmap)."""
    union = np.bitwise_or.reduce(lane_signatures(bitmask), axis=1)
    return union.astype(np.uint32).view(np.int32)


def subtile_stats(plan: SpmmPlan) -> dict:
    """Occupied (block, 128-row sub-window) pairs: what K2 pays, against
    the `total_blocks * nsub` that K1 pays."""
    nsub = plan.config.block_h // SUBWIN_ROWS
    if plan.total_blocks == 0:
        return {"occupied_subtiles": 0, "total_subtiles": 0, "occupancy": 0.0}
    union = np.bitwise_or.reduce(lane_signatures(plan.bitmask), axis=1)  # (TB,)
    occ = np.array([bin(int(u)).count("1") for u in union], dtype=np.int64).sum()
    total = plan.total_blocks * nsub
    return {
        "occupied_subtiles": int(occ),
        "total_subtiles": int(total),
        "occupancy": float(occ) / total,
    }


# Packed-subtile bitmask transport: only the occupied 128-row sub-tiles
# and their ids, rebuilt into the dense bitmask on the device with one
# scatter, so a plan on disk or on the wire costs O(occupied) bytes.


def pack_bitmask(bitmask):
    """(TB, words, K) -> (packed (S, 4, K) uint32, ids (S,) int32, nsub),
    S = occupied sub-tiles, ids index the flat (TB * nsub) sub-tile space."""
    bm = _bits_np(bitmask)
    tb, words, k = bm.shape
    if words % _WORDS_PER_SUB:
        raise ValueError(f"{words} words are not whole 128-row sub-windows")
    nsub = words // _WORDS_PER_SUB
    sub = bm.reshape(tb * nsub, _WORDS_PER_SUB, k)
    occupied = (sub != 0).any(axis=(1, 2))
    ids = np.nonzero(occupied)[0].astype(np.int32)
    return np.ascontiguousarray(sub[ids]), ids, nsub


def unpack_bitmask_np(packed, ids, total_blocks: int, words: int, k: int) -> np.ndarray:
    """Host inverse of `pack_bitmask` (test oracle): uint32 (TB, words, K)."""
    nsub = words // _WORDS_PER_SUB
    dense = np.zeros((total_blocks * nsub, _WORDS_PER_SUB, k), np.uint32)
    dense[_host(ids)] = _bits_np(packed)
    return dense.reshape(total_blocks, words, k)


def unpack_bitmask(packed, ids, total_blocks: int, words: int, k: int, device="cuda") -> torch.Tensor:
    """Inverse of `pack_bitmask` on `device` (the card unless the caller
    asks for the CPU; the JAX package's `unpack_bitmask_device`): one
    scatter into an int32 (TB, words, K) bitmask carrying the uint32 bits,
    as SpmmPlan holds it."""
    nsub = words // _WORDS_PER_SUB
    if not isinstance(packed, torch.Tensor):
        packed = torch.from_numpy(_bits_np(packed).view(np.int32))
    ids = torch.from_numpy(_host(ids).astype(np.int64))
    dense = torch.zeros(total_blocks * nsub, _WORDS_PER_SUB, k, dtype=torch.int32, device=device)
    dense[ids.to(device)] = packed.to(device)
    return dense.reshape(total_blocks, words, k)


def packed_stats(bitmask) -> dict:
    """Bytes of the dense bitmask against its packed form (the occupied
    sub-tiles and their ids), and the share saved."""
    packed, ids, _ = pack_bitmask(bitmask)
    dense_b = _bits_np(bitmask).nbytes
    packed_b = packed.nbytes + ids.nbytes
    return {
        "dense_bytes": int(dense_b),
        "packed_bytes": int(packed_b),
        "saving": 1.0 - packed_b / max(dense_b, 1),
    }

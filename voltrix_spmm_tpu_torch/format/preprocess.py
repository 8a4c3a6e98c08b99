"""CSR -> binned block-CSR preprocessing, numpy path.

Counterpart of voltrix_spmm_tpu/format/preprocess.py: the same
vectorised numpy pass (sort, unique, scatter), so a CSR gives the same
plan arrays bit for bit in both packages. The result is wrapped in
torch tensors on the CPU; `SpmmPlan.to` moves it to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .plan import PlanConfig, SpmmPlan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_np(bitmask) -> np.ndarray:
    """The plan's int32 bitmask as the uint32 words it stores."""
    return np.ascontiguousarray(_host(bitmask)).view(np.uint32)


def csr_preprocess(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig = PlanConfig(),
    backend: str = "numpy",
    num_cols: int | None = None,
    values=None,
) -> SpmmPlan:
    """Build an `SpmmPlan` (tensors on the CPU) from a binary CSR."""
    if backend != "numpy":
        raise NotImplementedError(
            f"backend={backend!r}: the port has only the numpy preprocess; "
            "the native C++ backend is ROADMAP.md item 1"
        )
    if values is not None:
        raise NotImplementedError(
            "weighted plans (values=) need kernel K4: ROADMAP.md item 11"
        )
    if config.cluster_cols:
        raise NotImplementedError(
            "cluster_cols plans need format/cluster.py and kernel K2: "
            "ROADMAP.md item 1"
        )
    if config.pack_order != "natural" or config.seg_interleaved:
        raise NotImplementedError(
            "pack_order='incidence' and seg_interleaved are TPU gather "
            "layouts the port does not build: ROADMAP.md item 18"
        )
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if indptr.ndim != 1 or indptr.shape[0] != num_nodes + 1 or indices.ndim != 1:
        raise ValueError(
            f"bad CSR: indptr {indptr.shape}, indices {indices.shape}, "
            f"num_nodes {num_nodes}"
        )
    return _numpy_preprocess(indptr, indices, num_nodes, config, num_cols)


def pad_empty_windows(blocks_per_window: np.ndarray, unroll: int) -> np.ndarray:
    """Give zero-block windows `unroll` zero-bit padding blocks when cheap
    (skipped when empty windows dominate; the same rule as the JAX
    package, so both build the same plans)."""
    empty = blocks_per_window == 0
    n_empty = int(empty.sum())
    if n_empty == 0:
        return blocks_per_window
    real_blocks = int(blocks_per_window.sum())
    if n_empty * unroll > max(64, real_blocks // 8):
        return blocks_per_window
    out = blocks_per_window.copy()
    out[empty] = unroll
    return out


def _plan(config, num_nodes, num_cols, bitmask, hind, window_of_block,
          block_ptr, num_edges, has_empty_windows) -> SpmmPlan:
    return SpmmPlan(
        bitmask=torch.from_numpy(np.ascontiguousarray(bitmask).view(np.int32)),
        hind=torch.from_numpy(np.ascontiguousarray(hind, dtype=np.int32)),
        window_of_block=torch.from_numpy(
            np.ascontiguousarray(window_of_block, dtype=np.int32)
        ),
        block_ptr=torch.from_numpy(np.ascontiguousarray(block_ptr, dtype=np.int32)),
        config=config,
        num_nodes=num_nodes,
        num_edges=num_edges,
        num_windows=int(block_ptr.shape[0]) - 1,
        total_blocks=int(hind.shape[0]),
        has_empty_windows=has_empty_windows,
        num_cols=num_cols,
    )


def _numpy_preprocess(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_nodes: int,
    config: PlanConfig,
    num_cols: int | None = None,
) -> SpmmPlan:
    span = num_cols if num_cols is not None else num_nodes
    W, K = config.block_h, config.block_w
    words = config.words_per_col
    num_windows = max(_cdiv(num_nodes, W), 1)

    deg = np.diff(indptr)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    cols = indices.astype(np.int64)

    # deduplicate (row, col) so every bit is set exactly once
    edge_key = np.unique(rows * span + cols)
    rows = edge_key // span
    cols = edge_key % span
    nnz = int(rows.shape[0])

    if nnz == 0:
        return _plan(
            config, num_nodes, num_cols,
            bitmask=np.zeros((0, words, K), np.uint32),
            hind=np.zeros((0, K), np.int32),
            window_of_block=np.zeros((0,), np.int32),
            block_ptr=np.zeros((num_windows + 1,), np.int32),
            num_edges=0,
            has_empty_windows=True,
        )

    win = rows // W
    seg = config.gather_segment
    num_segs_total = _cdiv(span, seg)
    # sorted-unique (window, column segment): at seg=1 the window-local
    # sort + dedup + packed column numbering; at seg>1 the aligned-run
    # coverage of the neighbour set
    wc = win * num_segs_total + cols // seg
    uniq_wc, edge_to_unique = np.unique(wc, return_inverse=True)
    uniq_win = uniq_wc // num_segs_total
    uniq_seg = (uniq_wc % num_segs_total).astype(np.int64)

    win_unique = np.bincount(uniq_win, minlength=num_windows)
    blocks_per_window = -(-(win_unique * seg) // K)
    if config.block_unroll > 1:
        u = config.block_unroll
        blocks_per_window = -(-blocks_per_window // u) * u
    blocks_per_window = pad_empty_windows(blocks_per_window, config.block_unroll)
    block_ptr = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(blocks_per_window, out=block_ptr[1:])
    total_blocks = int(block_ptr[-1])

    win_unique_start = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(win_unique, out=win_unique_start[1:])
    # position of each unique segment in its window's packed numbering
    # (a segment never straddles a block since K % seg == 0)
    upos = (
        np.arange(uniq_wc.shape[0], dtype=np.int64) - win_unique_start[uniq_win]
    ) * seg
    ublock = block_ptr[uniq_win] + upos // K
    ulane = upos % K

    # padding lanes carry the canonical [0..seg) run with zero bits;
    # covered rows may pass num_nodes-1 at the tail (zero bits too), so
    # consumers skip or clip them
    offs = np.arange(seg, dtype=np.int64)
    hind = np.tile(offs.astype(np.int32), (total_blocks, K // seg))
    hind[ublock[:, None], ulane[:, None] + offs[None, :]] = (
        uniq_seg[:, None] * seg + offs[None, :]
    ).astype(np.int32)

    # row-packed bitmask: each edge lights one distinct bit, so a
    # scatter-add of (1 << shift) is an exact bitwise OR
    r_local = (rows % W).astype(np.int64)
    e_block = ublock[edge_to_unique]
    e_lane = ulane[edge_to_unique] + cols % seg
    bitmask = np.zeros((total_blocks, words, K), dtype=np.uint32)
    np.add.at(
        bitmask,
        (e_block, r_local // 32, e_lane),
        (np.uint32(1) << (r_local % 32).astype(np.uint32)),
    )

    window_of_block = np.repeat(
        np.arange(num_windows, dtype=np.int32), blocks_per_window
    )
    return _plan(
        config, num_nodes, num_cols,
        bitmask=bitmask,
        hind=hind,
        window_of_block=window_of_block,
        block_ptr=block_ptr,
        num_edges=nnz,
        has_empty_windows=bool((blocks_per_window == 0).any()),
    )


def expand_bitmask_np(bitmask, block_h: int) -> np.ndarray:
    """Expand a row-packed bitmask (B, words, K) -> dense 0/1 (B, block_h, K)."""
    bitmask = _bits_np(bitmask)
    nblocks, words, K = bitmask.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (bitmask[:, :, None, :] >> shifts[None, None, :, None]) & np.uint32(1)
    return bits.reshape(nblocks, words * 32, K)[:, :block_h].astype(np.uint8)


def plan_to_dense(plan: SpmmPlan) -> np.ndarray:
    """Reconstruct the dense (num_nodes, source_rows) adjacency from a
    plan (test oracle)."""
    W = plan.config.block_h
    dense = np.zeros((plan.num_nodes, plan.source_rows), dtype=np.uint8)
    if plan.total_blocks == 0:
        return dense
    bits = expand_bitmask_np(plan.bitmask, W)  # (B, W, K)
    hind = _host(plan.hind).astype(np.int64)
    wob = _host(plan.window_of_block)
    b_idx, r_idx, l_idx = np.nonzero(bits)
    global_rows = wob[b_idx] * W + r_idx
    global_cols = hind[b_idx, l_idx]
    keep = global_rows < plan.num_nodes
    dense[global_rows[keep], global_cols[keep]] = 1
    return dense


def plan_stats(plan: SpmmPlan) -> dict:
    """Packing statistics (blocks, gathered rows, fill)."""
    slots = plan.total_blocks * plan.config.block_h * plan.config.block_w
    return {
        "num_nodes": plan.num_nodes,
        "nnz": plan.num_edges,
        "num_windows": plan.num_windows,
        "total_blocks": plan.total_blocks,
        "gather_rows": plan.gather_rows,
        "expanded_slots": slots,
        "fill_ratio": plan.num_edges / slots if slots else 0.0,
        "gather_expansion": plan.gather_rows / max(plan.num_edges, 1),
    }

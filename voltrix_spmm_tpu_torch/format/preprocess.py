"""CSR -> binned block-CSR preprocessing.

Counterpart of voltrix_spmm_tpu/format/preprocess.py: the same
vectorised numpy pass (sort, unique, scatter), and the native C++/OpenMP
preprocess beside it (runtime/native.py), so a CSR gives the same plan
arrays bit for bit in both packages and on both backends. The result is
wrapped in torch tensors on the CPU; `SpmmPlan.to` moves it to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .cluster import _bits_np, _host, block_occupancy, cluster_window_columns
from .plan import PlanConfig, SpmmPlan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """np.unique(keys) by a sort and a neighbour mask: the same sorted
    array, without the hash pass that numpy >= 2.3 runs in np.unique,
    about 10x slower than the sort on tens of millions of int64 keys."""
    keys = np.sort(keys)
    if keys.shape[0] < 2:
        return keys
    keep = np.empty(keys.shape[0], dtype=bool)
    keep[0] = True
    np.not_equal(keys[1:], keys[:-1], out=keep[1:])
    return keys[keep]


def csr_preprocess(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig = PlanConfig(),
    backend: str = "auto",
    num_cols: int | None = None,
    values=None,
) -> SpmmPlan:
    """Build an `SpmmPlan` (tensors on the CPU) from a CSR.

    backend: "numpy", "native" (the C++/OpenMP preprocess of
    runtime/native.py, built with g++ at first use; raises when it does not
    build), or "auto" (native when it builds, else numpy), as in the JAX
    package. Both give the same plan bit for bit.

    values: optional per-edge weights aligned with `indices`. The plan then
    carries a dense float32 (total_blocks, block_h, block_w) value plane
    aligned with the bitmask, and `ops.spmm` runs the weighted kernel K4.
    Duplicate (row, col) edges sum their values, the scipy CSR convention.
    Weighted plans need exact lanes (gather_segment 1, no cluster_cols) and
    block_h % 32 == 0 (K5 reads whole bitmask words); the numpy path builds
    them, whatever the backend."""
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}: 'auto', 'native' or 'numpy'")
    if values is not None:
        if config.gather_segment != 1:
            raise ValueError("weighted plans need exact lanes (gather_segment=1)")
        if config.cluster_cols:
            raise ValueError("weighted plans do not support column clustering")
        if config.block_h % 32:
            raise ValueError(
                f"weighted plans need block_h % 32 == 0 (got {config.block_h}): "
                "spmm_weighted_dvalues reads row bits in uint32 words"
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
    if values is not None:
        values = np.asarray(values, dtype=np.float32)
        if values.shape != indices.shape:
            raise ValueError(f"values {values.shape} must align with indices {indices.shape}")
        backend = "numpy"  # the native preprocess covers binary plans
    if backend == "auto":
        from ..runtime.native import native_available

        backend = "native" if native_available() else "numpy"
    if backend == "native":
        from ..runtime.native import native_cluster, native_preprocess

        plan = native_preprocess(indptr, indices, num_nodes, config, num_cols)
        return native_cluster(plan) if config.cluster_cols else plan
    plan = _numpy_preprocess(indptr, indices, num_nodes, config, num_cols, values)
    if config.cluster_cols:
        # two-level windows: sort each window's lanes by sub-window
        # signature and precompute K2's skip bitmap
        plan = cluster_window_columns(plan)
        plan.occ = torch.from_numpy(block_occupancy(plan.bitmask))
    return plan


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


def _sorted_unique_inverse(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(keys, return_inverse=True) by a stable sort, for the
    reason `_sorted_unique` gives."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    first = np.ones(sorted_keys.shape[0], dtype=bool)
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=first[1:])
    inverse = np.empty(keys.shape[0], dtype=np.int64)
    inverse[order] = np.cumsum(first) - 1
    return sorted_keys[first], inverse


def _plan(config, num_nodes, num_cols, bitmask, hind, window_of_block,
          block_ptr, num_edges, has_empty_windows, values=None) -> SpmmPlan:
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
        values=None if values is None else torch.from_numpy(values),
    )


def _numpy_preprocess(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_nodes: int,
    config: PlanConfig,
    num_cols: int | None = None,
    values: np.ndarray | None = None,
) -> SpmmPlan:
    span = num_cols if num_cols is not None else num_nodes
    W, K = config.block_h, config.block_w
    words = config.words_per_col
    num_windows = max(_cdiv(num_nodes, W), 1)

    deg = np.diff(indptr)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    cols = indices.astype(np.int64)

    # deduplicate (row, col) so every bit is set exactly once; weighted
    # plans sum duplicate values, in np.add.at order as the JAX package does
    vals = None
    if values is None:
        edge_key = _sorted_unique(rows * span + cols)
    else:
        edge_key, edge_inv = _sorted_unique_inverse(rows * span + cols)
        vals = np.zeros(edge_key.shape[0], np.float32)
        np.add.at(vals, edge_inv, values)
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
            values=None if vals is None else np.zeros((0, W, K), np.float32),
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

    vplane = None
    if vals is not None:
        # each deduplicated edge owns one slot of the dense value plane
        vplane = np.zeros((total_blocks, W, K), dtype=np.float32)
        vplane[e_block, r_local, e_lane] = vals

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
        values=vplane,
    )


def coverage_expansion(indptr, indices, num_nodes: int, block_h: int, seg: int) -> float:
    """Gather rows per nnz of a coverage plan (gather_segment=seg, windows
    of block_h rows), straight from the CSR without building the plan.
    The tuner's space and `fused_auto_config` gate K3 on it."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    nnz = int(indices.shape[0])
    if nnz == 0:
        return 0.0
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    nseg = _cdiv(num_nodes, seg)
    keys = (rows // block_h) * nseg + indices // seg
    return float(_sorted_unique(keys).shape[0] * seg) / nnz


def density_split_stats(
    indptr,
    indices,
    num_nodes: int,
    block_h: int,
    q: int,
    thresh: int | None = None,
) -> tuple[float, float]:
    """(gather_rows_fraction, slot_inflation) of a density split: the
    (window, col // q) groups holding >= thresh distinct needed columns
    (default max(2, q // 2)) go to a dense side that covers each group as
    one run of q rows, the rest stay exact lanes. Both are relative to the
    exact lane count u: rows fraction (dense_groups + tail_lanes) / u,
    slot inflation (q * dense_groups + tail_lanes) / u. Bit for bit the
    JAX package's statistic; the tuner gates its tall hybrid (K3 on the
    dense side, K2 on the rest) on it."""
    if thresh is None:
        thresh = max(2, q // 2)
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if indices.shape[0] == 0:
        return 1.0, 1.0
    span = num_nodes
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    uniq = np.unique((rows // block_h) * span + indices)
    u = int(uniq.shape[0])
    gkey = (uniq // span) * (span // q + 1) + (uniq % span) // q
    # uniq sorted by (window, col): gkey nondecreasing
    boundaries = np.flatnonzero(np.diff(gkey)) + 1
    counts = np.diff(np.concatenate(([0], boundaries, [u])))
    dense = counts >= thresh
    nd = int(dense.sum())
    tail = int(counts[~dense].sum())
    return (nd + tail) / u, (nd * q + tail) / u


# K3 joins the tuner's space, and `fused_auto_config` picks its plan, when
# an h2048 / seg128 coverage plan covers at most this many gather rows per
# nnz. The JAX package's constant, kept so the gate means the same in both
# packages; on the card the race (chip_smoke.py path O) decides among the
# candidates that pass it.
FUSED_COVERAGE_THRESHOLD = 0.5


def fused_auto_config(indptr, indices, num_nodes: int):
    """K3's coverage plan config when this matrix's coverage waste is under
    `FUSED_COVERAGE_THRESHOLD`, else None."""
    cov = coverage_expansion(indptr, indices, num_nodes, 2048, 128)
    if cov <= FUSED_COVERAGE_THRESHOLD:
        return PlanConfig(2048, 128, gather_segment=128, block_unroll=4)
    return None


def csr_transpose(indptr, indices, num_nodes: int, values=None,
                  num_cols: int | None = None):
    """CSR(A) -> CSR(A^T) on the host by a stable counting sort.

    A is (num_nodes, span) with span = num_cols or num_nodes. Returns
    (indptr_t, indices_t, values_t) of the (span, num_nodes) transpose;
    values_t is None when values is None. With `csr_preprocess(...,
    values=...)` it builds the transpose plan that the weighted backward
    (`ops.spmm_weighted_ad`) runs over."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    span = num_cols if num_cols is not None else num_nodes
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")  # stable keeps rows sorted
    indptr_t = np.zeros(span + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=span), out=indptr_t[1:])
    values_t = None if values is None else np.asarray(values, np.float32)[order]
    return indptr_t, rows[order], values_t


def edge_slot_map(plan: SpmmPlan, indptr, indices) -> np.ndarray:
    """Flat index into `plan.values` (int64, one per CSR edge), derived
    from the plan's hind and bitmask. With it a differentiable value plane
    is built from per-edge tensors `w`:

        plane = torch.zeros(tb * H * K).index_add_(0, slots, w).view(tb, H, K)

    Duplicate (row, col) edges share a slot, so the sum reproduces
    `csr_preprocess(values=...)`. Raises ValueError when an edge is not in
    the plan (a plan of another CSR)."""
    cfg = plan.config
    if cfg.gather_segment != 1 or cfg.cluster_cols:
        raise ValueError("edge_slot_map needs an exact-lane plan (gather_segment=1, "
                         "no cluster_cols)")
    W, K = cfg.block_h, cfg.block_w
    span = plan.source_rows
    bm = _host(plan.bitmask)
    hind = _host(plan.hind).astype(np.int64)
    wob = _host(plan.window_of_block).astype(np.int64)
    # real lanes carry at least one presence bit; padding lanes none
    b_idx, l_idx = np.nonzero((bm != 0).any(axis=1))
    keys = wob[b_idx] * span + hind[b_idx, l_idx]
    order = np.argsort(keys)
    keys_sorted = keys[order]
    lane_flat = (b_idx * K + l_idx)[order]

    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    rows = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64), np.diff(indptr))
    ekeys = (rows // W) * span + indices
    pos = np.searchsorted(keys_sorted, ekeys)
    if pos.shape[0] and not bool(
        (keys_sorted[np.minimum(pos, keys_sorted.shape[0] - 1)] == ekeys).all()
    ):
        # a real raise: a mismatch would scatter weights into other edges' slots
        raise ValueError("edge not represented in plan (wrong plan for this CSR?)")
    bl = lane_flat[pos] if pos.shape[0] else np.zeros(0, np.int64)
    return (bl // K) * (W * K) + (rows % W) * K + (bl % K)


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

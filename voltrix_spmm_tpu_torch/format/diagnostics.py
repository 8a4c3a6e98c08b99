"""Plan invariant checking (counterpart of
voltrix_spmm_tpu/format/diagnostics.py, with its named checks and
messages).

The plan is host-visible, so the invariants the kernels rely on can be
checked exactly before anything is launched: `validate_plan(plan)` raises
`PlanInvariantError` naming the violated invariant. The error subclasses
AssertionError, as in the JAX package, so callers catch the same type;
every check raises through an explicit `if`, so it also holds under
`python -O`. The bitmask is read as its uint32 bits.
"""

from __future__ import annotations

import numpy as np

from .cluster import _bits_np, _host
from .plan import SpmmPlan


class PlanInvariantError(AssertionError):
    pass


def _check(cond: bool, name: str, detail: str = ""):
    if not cond:
        raise PlanInvariantError(f"plan invariant violated: {name} {detail}")


def validate_plan(plan: SpmmPlan) -> None:
    cfg = plan.config
    W, K, words = cfg.block_h, cfg.block_w, cfg.words_per_col
    bm = _bits_np(plan.bitmask)
    hind = _host(plan.hind)
    wob = _host(plan.window_of_block)
    bp = _host(plan.block_ptr).astype(np.int64)

    _check(bm.shape == (plan.total_blocks, words, K), "bitmask shape", str(bm.shape))
    _check(hind.shape == (plan.total_blocks, K), "hind shape", str(hind.shape))
    _check(wob.shape == (plan.total_blocks,), "window_of_block shape")
    _check(bp.shape == (plan.num_windows + 1,), "block_ptr shape")

    _check(int(bp[0]) == 0, "block_ptr starts at 0")
    _check(int(bp[-1]) == plan.total_blocks, "block_ptr total")
    _check(bool((np.diff(bp) >= 0).all()), "block_ptr monotone")
    if cfg.block_unroll > 1:
        _check(
            bool((np.diff(bp) % cfg.block_unroll == 0).all()),
            "blocks/window multiple of block_unroll",
        )

    if plan.total_blocks:
        expect_wob = np.repeat(np.arange(plan.num_windows, dtype=np.int64), np.diff(bp))
        _check(bool((wob == expect_wob).all()), "window_of_block matches block_ptr")

        # gather indices in range of the source row space
        src = plan.source_rows
        seg = max(cfg.gather_segment, 1)
        upper = -(-src // seg) * seg
        _check(int(hind.min()) >= 0, "hind non-negative")
        _check(int(hind.max()) < max(upper, 1), "hind within padded source rows")

        if cfg.gather_segment > 1:
            runs = hind.reshape(plan.total_blocks, K // seg, seg)
            _check(bool((runs[:, :, 0] % seg == 0).all()), "gather runs seg-aligned")
            _check(bool((runs == runs[:, :, :1] + np.arange(seg)).all()),
                   "gather runs consecutive")

        # rows beyond num_nodes in the tail window must carry no bits
        tail = plan.padded_nodes - plan.num_nodes
        if tail > 0:
            from .preprocess import expand_bitmask_np

            bits = expand_bitmask_np(bm, W)
            tail_rows = bits[wob == plan.num_windows - 1][:, W - tail:]
            _check(int(tail_rows.sum()) == 0, "padded tail rows empty")

    _check(
        plan.has_empty_windows == bool((np.diff(bp) == 0).any()),
        "has_empty_windows flag accurate",
    )

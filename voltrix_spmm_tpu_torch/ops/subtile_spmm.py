"""Kernel K2, the sub-window-skipping SpMM, its wrapper and its plain
version.

`spmm_subtile(plan, feat)` computes what the JAX package's
`spmm_pallas(subtile=True)` returns, out = A @ feat, on plans with
block_h % 128 == 0, with the CUDA kernel in csrc/spmm_subtile.cu (it
replaces voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_subtiled_kernel; the
source says how it is laid out and what bounds it). The skip bitmap is
`plan.occ` (column-clustered plans carry it, see format/cluster.py) or,
when the plan has none, the per-block occupancy of its bitmask, computed
once with the plan's work list (ops/block_spmm.py:plan_walk).

A CPU tensor takes the plain version, `spmm_subtile_reference`. A CUDA
tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.plan import SpmmPlan
from ..jit import build
from .block_spmm import Walk, _check, cast_out, launch_walk, plan_walk
from .reference import CHUNK_BYTES, block_sum, check_binary, clipped_gather

SUBWIN_ROWS = 128


@functools.cache
def load_library():
    """Build (or reuse) the kernel library; return (launch, error_string)."""
    rt = build("spmm_subtile", ["spmm_subtile.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_subtile_f32", [p] * 8 + [i] * 9 + [p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


def _check_geometry(plan: SpmmPlan) -> None:
    cfg = plan.config
    if cfg.block_h % SUBWIN_ROWS or cfg.block_h > 32 * SUBWIN_ROWS:
        raise ValueError(
            f"the subtile SpMM needs block_h % 128 == 0 and at most 32 "
            f"sub-windows (block_h <= 4096), got block_h={cfg.block_h}"
        )
    if plan.total_blocks % cfg.block_unroll:
        raise ValueError(
            f"total_blocks={plan.total_blocks} is not a multiple of "
            f"block_unroll={cfg.block_unroll}"
        )


def subtile_occupancy(bitmask: torch.Tensor) -> torch.Tensor:
    """(TB, words, K) int32 -> int32 (TB,) carrying uint32 bits: bit s set
    iff 128-row sub-window s of the block holds a bit (the JAX package's
    `_subtile_occupancy`, on the bitmask's device)."""
    tb, words, _ = bitmask.shape
    nsub = words // 4
    any_sub = (bitmask != 0).any(dim=2).reshape(tb, nsub, 4).any(dim=2)
    weights = 1 << torch.arange(nsub, dtype=torch.int64, device=bitmask.device)
    occ = (any_sub.long() * weights).sum(dim=1)
    return torch.where(occ >= 2**31, occ - 2**32, occ).to(torch.int32)


def _plan_occupancy(plan: SpmmPlan) -> torch.Tensor:
    return plan.occ if plan.occ is not None else subtile_occupancy(plan.bitmask)


def group_keep(occ: torch.Tensor, unroll: int, nsub: int) -> torch.Tensor:
    """float (TB, nsub) 0/1: sub-window s of block b is kept iff bit s of
    the OR of occ over b's unroll group is set, as the TPU kernel skips
    (pallas_spmm.py:445-449)."""
    groups = occ.reshape(-1, unroll)
    union = groups[:, 0]
    for i in range(1, unroll):
        union = union | groups[:, i]
    shifts = torch.arange(nsub, dtype=torch.int32, device=occ.device)
    bits = (union[:, None] >> shifts) & 1  # arithmetic shift, & 1 reads bit 31 too
    return bits.float().repeat_interleave(unroll, dim=0)


def spmm_subtile_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                           chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K2: the masked block sum of `spmm_reference`,
    adding only the sub-windows whose group occupancy bit is set."""
    spmm_subtile_reference.calls += 1
    check_binary(plan, feat)
    _check_geometry(plan)
    d = feat.shape[1]
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=out_dtype, device=feat.device)
    keep = group_keep(_plan_occupancy(plan), plan.config.block_unroll,
                      plan.config.block_h // SUBWIN_ROWS)
    out = block_sum(plan, feat, clipped_gather(plan, feat), keep, chunk_bytes)
    return out.to(out_dtype)


spmm_subtile_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def subtile_walk(plan: SpmmPlan) -> Walk:
    """K2's work list for `plan` (`block_spmm.plan_walk`), with the plan's
    occupancy computed once."""
    return plan_walk(plan, "spmm_subtile", lambda: _plan_occupancy(plan))


def spmm_subtile(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K2 (float32 in, float32
    accumulation, cast to `out_dtype` at the end)."""
    if feat.device.type == "cpu":
        return spmm_subtile_reference(plan, feat, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"spmm_subtile runs on cuda or cpu tensors, not {feat.device}")
    _check(plan, feat, "spmm_subtile")
    _check_geometry(plan)
    out = torch.empty(plan.num_nodes, feat.shape[1], dtype=torch.float32, device=feat.device)
    if out.numel():
        launch_walk("spmm_subtile", load_library(), plan, feat, out, subtile_walk(plan))
        spmm_subtile.launches += 1
    return cast_out(out, out_dtype)


spmm_subtile.launches = 0  # plain-int launch count, read by chip_smoke.py

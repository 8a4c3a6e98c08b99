"""Kernel K3, the coverage-fused SpMM, its wrapper and its plain version.

`spmm_fused(plan, feat)` computes what the JAX package's
`spmm_pallas_fused` returns, out = A @ feat, on coverage plans
(gather_segment >= 8), with the CUDA kernel in csrc/spmm_fused.cu (it
replaces voltrix_spmm_tpu/ops/pallas_spmm_fused.py:_fused_kernel; the
source says how it is laid out and what bounds it). X arrives in runs of
`gather_segment` consecutive rows that start at the run heads
hind[:, ::seg]; rows past the last source row read as zero.

A CPU tensor takes the plain version, `spmm_fused_reference`. A CUDA
tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.plan import SpmmPlan
from ..jit import build
from .block_spmm import _INT_MAX, _check, cast_out, launch
from .reference import CHUNK_BYTES, block_sum, check_binary

_WARPS = 16  # 32-row words a thread block of the kernel owns


@functools.cache
def load_library():
    """Build (or reuse) the kernel library; return (launch, error_string)."""
    rt = build("spmm_fused", ["spmm_fused.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_fused_f32", [p, p, p, p, p, i, i, i, i, i, i, i, i, p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


def _check_geometry(plan: SpmmPlan) -> None:
    cfg = plan.config
    if cfg.gather_segment < 8:
        raise ValueError(
            f"the fused SpMM needs a coverage plan (gather_segment >= 8), got "
            f"gather_segment={cfg.gather_segment}"
        )
    if cfg.block_w % 128 or cfg.block_h % 32:
        raise ValueError(
            f"the fused SpMM needs block_w % 128 == 0 and block_h % 32 == 0, "
            f"got {cfg.block_h}x{cfg.block_w}"
        )
    if plan.total_blocks % cfg.block_unroll:
        raise ValueError(
            f"total_blocks={plan.total_blocks} is not a multiple of "
            f"block_unroll={cfg.block_unroll}"
        )


def spmm_fused_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                         chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K3: gather each seg-run from its head
    hind[b, j*seg] (rows >= source_rows read as zero), then the masked
    block sum of `spmm_reference`."""
    spmm_fused_reference.calls += 1
    check_binary(plan, feat)
    _check_geometry(plan)
    n, d = feat.shape
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=out_dtype, device=feat.device)
    seg, k = plan.config.gather_segment, plan.config.block_w
    heads = plan.hind[:, ::seg].long()  # (TB, K / seg) run starts
    offs = torch.arange(seg, device=feat.device)

    def gather(b0, b1):
        rows = (heads[b0:b1, :, None] + offs).reshape(-1)
        xg = feat.index_select(0, rows.clamp(max=n - 1)).float()
        xg = torch.where((rows < n)[:, None], xg, 0.0)
        return xg.reshape(b1 - b0, k, d)

    return block_sum(plan, feat, gather, chunk_bytes=chunk_bytes).to(out_dtype)


spmm_fused_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def spmm_fused(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K3 (float32 in, float32
    accumulation, cast to `out_dtype` at the end)."""
    if feat.device.type == "cpu":
        return spmm_fused_reference(plan, feat, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"spmm_fused runs on cuda or cpu tensors, not {feat.device}")
    _check(plan, feat, "spmm_fused")
    _check_geometry(plan)
    cfg = plan.config
    if plan.num_windows * -(-cfg.words_per_col // _WARPS) > _INT_MAX:
        raise ValueError("num_windows * block_h / 512 exceeds spmm_fused's grid limits")
    d = feat.shape[1]
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=feat.device)
    if out.numel():
        launch(
            "spmm_fused", load_library(), feat,
            plan.bitmask.data_ptr(), plan.hind.data_ptr(), plan.block_ptr.data_ptr(),
            feat.data_ptr(), out.data_ptr(),
            plan.num_windows, cfg.words_per_col, cfg.block_h, cfg.block_w,
            cfg.gather_segment, plan.num_nodes, plan.source_rows, d,
        )
        spmm_fused.launches += 1
    return cast_out(out, out_dtype)


spmm_fused.launches = 0  # plain-int launch count, read by chip_smoke.py

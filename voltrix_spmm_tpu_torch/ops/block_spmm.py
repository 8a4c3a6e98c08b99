"""Kernel K1, the block SpMM, and its wrapper.

`spmm_block(plan, feat)` computes what the JAX package's
`spmm_pallas(subtile=False)` returns, out = A @ feat, with the CUDA
kernel in csrc/spmm_block.cu (it replaces
voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_block_kernel; the source says
how it is laid out and what bounds it). The library is built with nvcc
at first use (see jit/compiler.py).

A CPU tensor takes the plain version, `ops.reference.spmm_reference`. A
CUDA tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.plan import SpmmPlan
from ..jit import build
from .reference import spmm_reference

_COLS = 32  # feature columns per thread block (one per lane of a warp)
_INT_MAX = 2**31 - 1


@functools.cache
def load_library():
    """Build (or reuse) the kernel library; return (launch, error_string)."""
    rt = build("spmm_block", ["spmm_block.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = rt.function(
        "voltrix_spmm_block_f32", [p, p, p, p, p, i, i, i, i, i, i, i, p]
    )
    error_string = rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)
    return launch, error_string


def _check(plan: SpmmPlan, feat: torch.Tensor) -> None:
    cfg = plan.config
    if feat.dtype != torch.float32:
        raise TypeError(f"spmm_block takes float32 features, got {feat.dtype}")
    if feat.dim() != 2 or feat.shape[0] != plan.source_rows:
        raise ValueError(
            f"feat must be (source_rows={plan.source_rows}, D), got {tuple(feat.shape)}"
        )
    if not feat.is_contiguous():
        raise ValueError("spmm_block needs row-major contiguous features")
    if plan.values is not None or plan.src_perm is not None or cfg.seg_interleaved:
        raise ValueError(
            "spmm_block takes binary plans in natural lane order only "
            "(no values, src_perm or seg_interleaved)"
        )
    shapes = {
        "bitmask": (plan.total_blocks, cfg.words_per_col, cfg.block_w),
        "hind": (plan.total_blocks, cfg.block_w),
        "block_ptr": (plan.num_windows + 1,),
    }
    for name, shape in shapes.items():
        t = getattr(plan, name)
        if t.device != feat.device:
            raise ValueError(
                f"plan.{name} is on {t.device}, feat on {feat.device}: move the "
                "plan once with SpmmPlan.to(device)"
            )
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"plan.{name} must be contiguous int32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if max(plan.num_nodes, plan.source_rows, feat.shape[1]) > _INT_MAX:
        raise ValueError("spmm_block indexes rows and columns with 32-bit ints")
    if -(-feat.shape[1] // _COLS) > 65535 or cfg.words_per_col > 65535:
        raise ValueError("D or block_h exceeds the kernel's grid limits")


def spmm_block(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K1 (float32 in, float32
    accumulation, cast to `out_dtype` at the end)."""
    if feat.device.type == "cpu":
        return spmm_reference(plan, feat, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"spmm_block runs on cuda or cpu tensors, not {feat.device}")
    _check(plan, feat)
    d = feat.shape[1]
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=feat.device)
    if out.numel():
        launch, error_string = load_library()
        with torch.cuda.device(feat.device):
            stream = torch.cuda.current_stream(feat.device).cuda_stream
            rc = launch(
                plan.bitmask.data_ptr(), plan.hind.data_ptr(),
                plan.block_ptr.data_ptr(), feat.data_ptr(), out.data_ptr(),
                plan.num_windows, plan.config.words_per_col, plan.config.block_h,
                plan.config.block_w, plan.num_nodes, plan.source_rows, d, stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"spmm_block launch failed: {error_string(rc).decode()} ({rc})"
            )
        spmm_block.launches += 1
    if out_dtype is None or out_dtype == torch.float32:
        return out
    return out.to(out_dtype)


spmm_block.launches = 0  # plain-int launch count, read by chip_smoke.py

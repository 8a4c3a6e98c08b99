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


def _check(plan: SpmmPlan, feat: torch.Tensor, name: str = "spmm_block") -> None:
    """What every CUDA SpMM kernel of the port takes: float32 row-major
    features on the plan's device, a binary plan in natural lane order
    with contiguous int32 arrays, and 32-bit row and column indices."""
    cfg = plan.config
    if feat.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 features, got {feat.dtype}")
    if feat.dim() != 2 or feat.shape[0] != plan.source_rows:
        raise ValueError(
            f"feat must be (source_rows={plan.source_rows}, D), got {tuple(feat.shape)}"
        )
    if not feat.is_contiguous():
        raise ValueError(f"{name} needs row-major contiguous features")
    if plan.values is not None:
        raise ValueError(
            f"plan carries a value plane; use ops.spmm(plan, feat) or "
            f"spmm_weighted: {name} is the binary SpMM"
        )
    if plan.src_perm is not None or cfg.seg_interleaved:
        raise ValueError(
            f"{name} takes binary plans in natural lane order only "
            "(no src_perm or seg_interleaved)"
        )
    shapes = {
        "bitmask": (plan.total_blocks, cfg.words_per_col, cfg.block_w),
        "hind": (plan.total_blocks, cfg.block_w),
        "block_ptr": (plan.num_windows + 1,),
    }
    if plan.occ is not None:
        shapes["occ"] = (plan.total_blocks,)
    for field, shape in shapes.items():
        t = getattr(plan, field)
        if t.device != feat.device:
            raise ValueError(
                f"plan.{field} is on {t.device}, feat on {feat.device}: move the "
                "plan once with SpmmPlan.to(device)"
            )
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"plan.{field} must be contiguous int32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if max(plan.num_nodes, plan.source_rows, feat.shape[1]) > _INT_MAX:
        raise ValueError(f"{name} indexes rows and columns with 32-bit ints")
    if -(-feat.shape[1] // _COLS) > 65535:
        raise ValueError(f"D exceeds {name}'s grid limits")


def launch(name: str, library, feat: torch.Tensor, *args) -> None:
    """Call `library`'s launch function on the current stream of feat's
    device; raise with CUDA's message if the launch was refused."""
    fn, error_string = library
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(rc).decode()} ({rc})")


def cast_out(out: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype is None or out_dtype == torch.float32:
        return out
    return out.to(out_dtype)


def spmm_block(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K1 (float32 in, float32
    accumulation, cast to `out_dtype` at the end)."""
    if feat.device.type == "cpu":
        return spmm_reference(plan, feat, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"spmm_block runs on cuda or cpu tensors, not {feat.device}")
    _check(plan, feat)
    if plan.config.words_per_col > 65535:
        raise ValueError("block_h exceeds spmm_block's grid limits")
    d = feat.shape[1]
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=feat.device)
    if out.numel():
        launch(
            "spmm_block", load_library(), feat,
            plan.bitmask.data_ptr(), plan.hind.data_ptr(),
            plan.block_ptr.data_ptr(), feat.data_ptr(), out.data_ptr(),
            plan.num_windows, plan.config.words_per_col, plan.config.block_h,
            plan.config.block_w, plan.num_nodes, plan.source_rows, d,
        )
        spmm_block.launches += 1
    return cast_out(out, out_dtype)


spmm_block.launches = 0  # plain-int launch count, read by chip_smoke.py

"""Kernel K8, the int8 SpMM, its wrapper and its plain version, with the
per-row quantization it runs on (counterpart of
voltrix_spmm_tpu/ops/quant.py).

`spmm_int8(plan, feat)` computes what the JAX package's
`spmm_pallas_int8` returns: the features are quantized per source row to
int8 with one float32 scale (`quantize_rows`), and out = A @ X' where
each gathered value of X' is bf16(bf16(q) * bf16(scale)), summed in
float32 (the TPU kernel's own arithmetic, quant.py:47-50). The CUDA kernel
is csrc/spmm_int8.cu (it replaces
voltrix_spmm_tpu/ops/quant.py:_quant_kernel): the edge walk of
csrc/spmm_walk.cuh that K1 runs, on int8 rows, over the plan's work list
for "spmm_int8" (`block_spmm.plan_walk`, with K8's own piece limits). The
quantization is plain torch, as in JAX, where it runs outside the Pallas
kernel.

A CPU tensor takes the plain version, `spmm_int8_reference`. A CUDA
tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..format.plan import SpmmPlan
from ..jit import build
from .block_spmm import _check, cast_out, launch_walk, plan_walk
from .reference import CHUNK_BYTES, block_sum, check_binary, clipped_gather


def quantize_rows(x: torch.Tensor, eps: float = 1e-30):
    """Per-row symmetric int8 quantization: (q int8 (N, D), scale float32
    (N, 1)) with scale = max(max|row|, eps) / 127 and q = round(x / scale)
    clipped to +-127 (round half to even, as jnp.round)."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


@functools.cache
def load_library():
    """Build (or reuse) the kernel library; return (launch, error_string)."""
    rt = build("spmm_int8", ["spmm_int8.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_int8", [p] * 8 + [i] * 9 + [p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


def _refuse(plan: SpmmPlan, feat: torch.Tensor, name: str) -> None:
    """The JAX package's refusals (quant.py:69-78), and float32 features
    only, as `block_spmm._check` refuses them on the card."""
    if plan.values is not None:
        raise ValueError(
            f"plan carries a value plane; {name} computes the binary SpMM: use "
            "ops.spmm(plan, feat)"
        )
    if plan.src_perm is not None or plan.config.seg_interleaved:
        raise ValueError(
            "pack_order='incidence' and seg_interleaved plans are pregather-only "
            f"layouts; {name} takes plans in natural lane order"
        )
    if feat.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 features, got {feat.dtype}")


def spmm_int8_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                        chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K8: quantize the rows, dequantize them through
    bfloat16 as the kernel does, then the masked block sum of
    `spmm_reference` in float32."""
    spmm_int8_reference.calls += 1
    _refuse(plan, feat, "spmm_int8_reference")
    check_binary(plan, feat)
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, feat.shape[1], dtype=out_dtype, device=feat.device)
    xq = dequantize_rows(*quantize_rows(feat), torch.bfloat16).float()
    return block_sum(plan, xq, clipped_gather(plan, xq), chunk_bytes=chunk_bytes).to(out_dtype)


spmm_int8_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def quantize_padded(feat: torch.Tensor):
    """quantize_rows of feat with zero columns added up to a multiple of 4:
    K8's lane copies 4 int8 columns as one 4-byte word, and a zero column
    changes no row's absmax."""
    d = feat.shape[1]
    return quantize_rows(feat if d % 4 == 0 else F.pad(feat, (0, -d % 4)))


def launch_quantized(plan: SpmmPlan, q: torch.Tensor, scale: torch.Tensor, d: int,
                     out_dtype=None) -> torch.Tensor:
    """Kernel K8 alone on CUDA rows that `quantize_padded` made (q int8
    (source_rows, d4), scale float32 (source_rows, 1)): out[num_nodes, d].
    `spmm_int8` checks the plan and the features, then calls this."""
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=q.device)
    if out.numel():
        launch_walk("spmm_int8", load_library(), plan, q, out, plan_walk(plan, "spmm_int8"),
                    scale)
        spmm_int8.launches += 1
    return cast_out(out, out_dtype)


def spmm_int8(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K8, with the features
    quantized per row to int8 (float32 accumulation, cast to `out_dtype`
    at the end)."""
    if feat.device.type == "cpu":
        return spmm_int8_reference(plan, feat, out_dtype)
    if feat.device.type != "cuda":
        raise ValueError(f"spmm_int8 runs on cuda or cpu tensors, not {feat.device}")
    _check(plan, feat, "spmm_int8")  # K1's checks: the JAX package's refusals and float32
    return launch_quantized(plan, *quantize_padded(feat), feat.shape[1], out_dtype)


spmm_int8.launches = 0  # plain-int launch count, read by chip_smoke.py

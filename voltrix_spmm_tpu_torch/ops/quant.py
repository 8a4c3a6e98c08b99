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

The features are float32 or bfloat16 rows. bf16 rows are quantized in
bf16, as jnp computes `quantize_rows` on them (quant.py:25-30): the
absmax, the scale and the division round to bf16, so the codes are not
those of the widened rows, and the scale, widened to float32, is already
a bf16 value (K8's bf16 rounding of it is then exact). The output is
cast once to `out_dtype`, default the features' dtype (quant.py:82,
:137).

K8 is the registered op ``torch.ops.voltrix.spmm_int8`` (ops/library.py)
on the int8 rows and scales that `quantize_padded` makes, which every
call goes through; its body runs the plain version on a CPU tensor
(`int8_rows_reference`, the dequantization and sum of
`spmm_int8_reference`), and on a CUDA tensor launches the kernel
(`k8_kernel`) or raises: there is no fallback. It has no gradient, as the
JAX package's `spmm_pallas_int8` has none.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..format.plan import SpmmPlan
from ..jit import build
from .block_spmm import FEAT_DTYPES, _check, cast_out, launch_walk
from .reference import CHUNK_BYTES, block_sum, check_binary, clipped_gather


def quantize_rows(x: torch.Tensor, eps: float = 1e-30):
    """Per-row symmetric int8 quantization: (q int8 (N, D), scale float32
    (N, 1)) with scale = max(max|row|, eps) / 127 and q = round(x / scale)
    clipped to +-127 (round half to even, as jnp.round), each step in x's
    dtype (bf16 rows: in bf16, as in JAX)."""
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
    """The JAX package's refusals (quant.py:69-78), and float32 or
    bfloat16 features only, as `block_spmm._check` takes them on the card
    (float16 rows are ROADMAP.md item 9)."""
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
    if feat.dtype not in FEAT_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 features, got {feat.dtype}")


def spmm_int8_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                        chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K8: quantize the rows (in their dtype),
    dequantize them through bfloat16 as the kernel does, then the masked
    block sum of `spmm_reference` in float32."""
    _refuse(plan, feat, "spmm_int8_reference")
    check_binary(plan, feat)
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    q, scale = quantize_rows(feat)
    return int8_rows_reference(plan, q, scale, feat.shape[1], chunk_bytes=chunk_bytes).to(out_dtype)


def int8_rows_reference(plan: SpmmPlan, q: torch.Tensor, scale: torch.Tensor, d: int, *,
                        chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K8 on rows already quantized (`quantize_rows`,
    or `quantize_padded` with its zero columns past d): float32
    (num_nodes, d). Counts one call of `spmm_int8_reference`."""
    spmm_int8_reference.calls += 1
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=torch.float32, device=q.device)
    xq = dequantize_rows(q[:, :d], scale, torch.bfloat16).float()
    return block_sum(plan, xq, clipped_gather(plan, xq), chunk_bytes=chunk_bytes)


spmm_int8_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def quantize_padded(feat: torch.Tensor):
    """quantize_rows of feat with zero columns added up to a multiple of 4:
    K8's lane copies 4 int8 columns as one 4-byte word, and a zero column
    changes no row's absmax."""
    d = feat.shape[1]
    return quantize_rows(feat if d % 4 == 0 else F.pad(feat, (0, -d % 4)))


def launch_quantized(plan: SpmmPlan, q: torch.Tensor, scale: torch.Tensor, d: int,
                     out_dtype=None, bf16_rows: bool = False) -> torch.Tensor:
    """The registered op ``torch.ops.voltrix.spmm_int8`` (ops/library.py)
    alone, on rows that `quantize_padded` made (q int8 (source_rows, d4),
    scale float32 (source_rows, 1)): out[num_nodes, d]. `spmm_int8` checks
    the plan and the features, then calls this; `bf16_rows` says that q
    and scale came from bf16 rows (the launch is counted apart)."""
    from . import library

    return cast_out(library.call_int8(plan, q, scale, d, bf16_rows), out_dtype)


def k8_kernel(plan: SpmmPlan, walk, q: torch.Tensor, scale: torch.Tensor, d: int,
              bf16_rows: bool = False) -> torch.Tensor:
    """K8 on the card over `walk`, the op's body (ops/library.py): float32
    (num_nodes, d). `bf16_rows`: q and scale were quantized from bf16 rows
    (the same kernel reads them; the launch is counted apart)."""
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=q.device)
    if out.numel():
        launch_walk("spmm_int8", load_library(), plan, q, out, walk, scale)
        spmm_int8.launches += 1
        if bf16_rows:
            spmm_int8.launches_bf16 += 1
    return out


def spmm_int8(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K8, with the features
    (float32 or bfloat16) quantized per row to int8 in their dtype (float32
    accumulation, cast to `out_dtype`, default feat's dtype, at the end).
    The quantization is plain torch; K8 is the registered op
    ``torch.ops.voltrix.spmm_int8``, which has no gradient, as the JAX
    package's `spmm_pallas_int8` has none."""
    if feat.device.type == "cpu":
        _refuse(plan, feat, "spmm_int8")
        check_binary(plan, feat)
    elif feat.device.type == "cuda":
        # K1's checks: the JAX package's refusals, float32 or bf16 features
        _check(plan, feat, "spmm_int8")
    else:
        raise ValueError(f"spmm_int8 runs on cuda or cpu tensors, not {feat.device}")
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    return launch_quantized(plan, *quantize_padded(feat), feat.shape[1], out_dtype,
                            bf16_rows=feat.dtype == torch.bfloat16)


spmm_int8.launches = 0  # plain-int launch count, read by chip_smoke.py
# of which on codes quantized from bf16 rows
spmm_int8.launches_bf16 = 0

import dataclasses

import torch

from .attention import (
    attention_bwd,
    attention_bwd_reference,
    attention_bwd_summed,
    attention_dkv,
    attention_dkv_reference,
    attention_dq,
    attention_dq_reference,
    scatter_lanes,
    spmm_attention,
    spmm_attention_ad,
    spmm_attention_reference,
)
from .attention_mh import (
    attention_mh_dkv,
    attention_mh_dkv_reference,
    attention_mh_dq,
    attention_mh_dq_reference,
    spmm_attention_mh,
    spmm_attention_mh_ad,
    spmm_attention_mh_reference,
)
from . import library
from .autodiff import spmm_ad
from .bitmask import expand_bitmask
from .block_spmm import bf16_compute, spmm_block
from .ell import (
    sddmm_ell,
    sddmm_ell_ad,
    spmm_ell,
    spmm_ell_ad,
    spmm_ell_dvals,
    spmm_ell_dvals_reference,
    spmm_ell_reference,
    spmm_ell_streamed,
)
from .fused_spmm import spmm_fused, spmm_fused_reference
from .hybrid import spmm_hybrid, spmm_hybrid_reference
from .quant import dequantize_rows, quantize_rows, spmm_int8, spmm_int8_reference
from .reference import spmm_reference, spmm_scipy
from .subtile_spmm import spmm_subtile, spmm_subtile_reference
from .weighted import (
    sddmm,
    spmm_weighted,
    spmm_weighted_ad,
    spmm_weighted_dvalues,
    spmm_weighted_dvalues_reference,
    spmm_weighted_reference,
)
from ..format.ell import EllPlan
from ..format.hybrid import HybridPlan
from ..format.plan import SpmmPlan
from ..format.stream import slice_plan_windows

IMPLS = ("auto", "pregather", "pallas", "fused", "weighted", "ell", "int8", "reference")
# what a list of window chunks runs: the JAX package's three, and the plain path
CHUNK_IMPLS = ("auto", "pregather", "pallas", "reference")


def _refuse_foreign(plan) -> None:
    """Raise for plans the port does not take: another package's plan
    types (the JAX package's SpmmPlan, HybridPlan or EllPlan), a chunk list
    that holds anything but SpmmPlans, and the TPU gather layouts
    (ROADMAP.md item 18). HybridPlans and chunk lists are checked part by
    part."""
    if isinstance(plan, (list, tuple)):
        for sub in plan:
            if isinstance(sub, (list, tuple, HybridPlan, EllPlan)):
                raise NotImplementedError(
                    f"a plan list holds SpmmPlan window chunks, not {type(sub).__name__}"
                )
            _refuse_foreign(sub)
        return
    if isinstance(plan, HybridPlan):
        _refuse_foreign(plan.dense)
        _refuse_foreign(plan.sparse)
        return
    if isinstance(plan, EllPlan):
        return
    if not isinstance(plan, SpmmPlan):
        raise NotImplementedError(
            f"{type(plan).__module__}.{type(plan).__name__} is not a plan of the port: "
            "build an SpmmPlan, HybridPlan, EllPlan or a list of SpmmPlan window chunks "
            "with voltrix_spmm_tpu_torch"
        )
    if plan.config.seg_interleaved or plan.src_perm is not None:
        raise NotImplementedError(
            "seg_interleaved and pack_order='incidence' plans are TPU gather "
            "layouts the port does not take: ROADMAP.md item 18"
        )


def _refuse_tiling(block_d, slots, precision) -> None:
    """The JAX package's TPU tiling and precision knobs: the H100 kernels
    pick their own tiles and sum in float32."""
    knobs = {"block_d": block_d, "slots": slots, "precision": precision}
    given = [k for k, v in knobs.items() if v is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: TPU tiling knobs; the H100 kernels' tiles are their "
            "work-list piece limits, which are not tuner knobs yet (ROADMAP.md item 9)"
        )


def concat_chunks(subs, feat: torch.Tensor, run, out_dtype=None) -> torch.Tensor:
    """run(sub) for each window chunk in turn, concatenated along rows. A
    chunk without blocks gives its zero rows and launches nothing."""
    if not subs:
        raise ValueError("an empty list of window chunks")
    outs = [
        run(s) if s.total_blocks else torch.zeros(
            s.num_nodes, feat.shape[1], dtype=out_dtype or feat.dtype, device=feat.device)
        for s in subs
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _chunked(plan, feat, run, out_dtype) -> torch.Tensor:
    """`concat_chunks` over `plan`'s window chunks, refusing value planes
    (the binary kernels would drop them) and plans the port does not take."""
    if any(getattr(s, "values", None) is not None for s in plan):
        raise ValueError(
            "plan carries a value plane; window chunks run the binary SpMM: use "
            "ops.spmm(plan, feat) on the whole plan"
        )
    _refuse_foreign(plan)
    return concat_chunks(plan, feat, run, out_dtype)


def spmm_streamed(plan, feat: torch.Tensor, *, num_chunks: int = 8, subtile: bool = False,
                  out_dtype=None) -> torch.Tensor:
    """Window-chunked SpMM: kernel K1 (K2 with `subtile=True`) on one
    chunk after another, the outputs concatenated along rows, so one
    chunk's work is in flight at a time. Every chunk runs K1 or K2, coverage
    chunks too, as in the JAX package (`spmm_ad` sends those to K3).

    `plan` is an SpmmPlan (sliced here into `num_chunks` with
    `format.stream.slice_plan_windows`) or the sub-plans as a list, tuple
    or one-shot iterable, which is materialised first."""
    subs = slice_plan_windows(plan, num_chunks) if isinstance(plan, SpmmPlan) else list(plan)
    kernel = spmm_subtile if subtile else spmm_block
    return _chunked(subs, feat, lambda s: kernel(s, feat, out_dtype), out_dtype)


def spmm(plan, feat, *, impl: str = "auto", subtile: bool | None = None, out_dtype=None,
         block_d=None, slots=None, precision=None, compute_dtype=None):
    """Public SpMM entry point: out = A @ feat.

    On an SpmmPlan, `impl` as the JAX package dispatches it:
    - "auto": "fused" for coverage plans (gather_segment >= 8), else
      "pregather";
    - "pregather" / "pallas": kernel K1, or K2 with `subtile=True` (a
      clustered plan without it runs K1, as in JAX);
    - "fused": kernel K3;
    - "weighted": kernel K4, which "auto" picks for a plan with a value
      plane (K1, K2 and K3 raise ValueError on one);
    - "int8": kernel K8, on the features quantized per row to int8;
    - "ell": kernel K6, which "auto" picks for an `EllPlan`; an EllPlan
      takes only "auto", "ell" and "reference", and "ell" only an EllPlan;
    - "reference": the plain version: K4's for a weighted plan (the JAX
      package's oracle would drop the plane and return A @ feat), K6's
      for an EllPlan.
    A `HybridPlan` runs `spmm_hybrid` (K3 on the dense side, K1 on the
    sparse side; K2 there when `subtile`, which defaults to the dense
    side's cluster_cols) under "auto", and the plain version of each side
    under "reference". A list or tuple of window chunks
    (`format.stream.slice_plan_windows`) runs `spmm_streamed` under "auto",
    "pregather" and "pallas" (K2 when `subtile`, which defaults to the
    first chunk's cluster_cols), and `spmm_reference` on each chunk under
    "reference". A CUDA tensor launches the kernels; a CPU tensor runs
    their plain versions.

    feat may be (N, D) or graph-batched (B, N, D): the batch folds into
    the feature axis, so one launch serves the whole batch.

    feat is float32 or bfloat16: K1, K2, K3, K4 and K6 read bf16 rows
    through their bf16 instantiations (K4 also a bf16 value plane) and K8
    quantizes them in bf16, and all sum in float32; the output is cast once
    to `out_dtype` (default feat's dtype). compute_dtype=torch.bfloat16
    rounds float32 features to bf16 (round to nearest even; K6 also its
    edge values) and runs the bf16 sources, the output defaulting to the
    caller's dtype, as the JAX package's compute_dtype does; K4 ignores it
    (the JAX package's weighted kernel does) and K8 refuses it.
    """
    _refuse_foreign(plan)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: the port has {', '.join(IMPLS)}")
    _refuse_tiling(block_d, slots, precision)
    if feat.dim() == 3:
        b, n, d = feat.shape
        flat = feat.permute(1, 0, 2).reshape(n, b * d)
        out = spmm(plan, flat, impl=impl, subtile=subtile, out_dtype=out_dtype,
                   compute_dtype=compute_dtype)
        return out.reshape(-1, b, d).permute(1, 0, 2)
    weighted = isinstance(plan, SpmmPlan) and plan.values is not None
    if isinstance(plan, EllPlan):
        if impl not in ("auto", "ell", "reference"):
            raise ValueError(f"an EllPlan runs impl 'auto', 'ell' or 'reference', not {impl!r}")
        if impl != "reference":
            return spmm_ell(plan, feat, out_dtype, compute_dtype=compute_dtype)
    if bf16_compute(compute_dtype) and not weighted:
        if impl == "int8":
            raise NotImplementedError(
                "compute_dtype=bfloat16 with impl='int8': the JAX package's spmm_pallas_int8 "
                "takes no compute_dtype (K8 quantizes the rows in their own dtype: pass bf16 "
                "rows to quantize bf16 rows)")
        out_dtype = feat.dtype if out_dtype is None else out_dtype
        feat = feat.to(torch.bfloat16)
        if isinstance(plan, EllPlan):  # K6's plain version on the values its kernel reads
            plan = dataclasses.replace(plan, vals=plan.vals.to(torch.bfloat16).float())
    if isinstance(plan, EllPlan):
        return spmm_ell_reference(plan, feat, out_dtype)
    if isinstance(plan, (list, tuple)):
        if impl not in CHUNK_IMPLS:
            raise ValueError(
                f"window-chunk plan lists run impl {', '.join(CHUNK_IMPLS)}, not {impl!r}"
            )
        if impl == "reference":
            return _chunked(plan, feat, lambda s: spmm_reference(s, feat, out_dtype), out_dtype)
        if subtile is None:
            subtile = bool(plan) and plan[0].config.cluster_cols
        return spmm_streamed(plan, feat, subtile=subtile, out_dtype=out_dtype)
    if isinstance(plan, HybridPlan):
        if impl == "reference":
            return spmm_hybrid_reference(plan, feat, out_dtype)
        if impl != "auto":
            raise ValueError(f"a HybridPlan runs impl 'auto' or 'reference', not {impl!r}")
        if subtile is None:
            subtile = plan.dense.config.cluster_cols
        return spmm_hybrid(plan, feat, subtile=subtile, out_dtype=out_dtype)
    if impl == "ell":
        raise ValueError("impl='ell' needs an EllPlan (csr_preprocess_ell)")
    if impl == "auto":
        if weighted:
            impl = "weighted"
        else:
            impl = "fused" if plan.config.gather_segment >= 8 else "pregather"
    if impl == "weighted":
        return spmm_weighted(plan, feat, out_dtype)
    if impl == "int8":
        return spmm_int8(plan, feat, out_dtype)
    if impl == "reference":
        if weighted:
            return spmm_weighted_reference(plan, feat, out_dtype)
        return spmm_reference(plan, feat, out_dtype)
    if impl == "fused":
        return spmm_fused(plan, feat, out_dtype)
    if subtile:
        return spmm_subtile(plan, feat, out_dtype)
    return spmm_block(plan, feat, out_dtype)


__all__ = [
    "attention_bwd",
    "attention_bwd_reference",
    "attention_bwd_summed",
    "attention_dkv",
    "attention_dkv_reference",
    "attention_dq",
    "attention_dq_reference",
    "attention_mh_dkv",
    "attention_mh_dkv_reference",
    "attention_mh_dq",
    "attention_mh_dq_reference",
    "concat_chunks",
    "dequantize_rows",
    "quantize_rows",
    "spmm",
    "spmm_ad",
    "spmm_attention",
    "spmm_attention_ad",
    "spmm_attention_reference",
    "spmm_attention_mh",
    "spmm_attention_mh_ad",
    "spmm_attention_mh_reference",
    "spmm_block",
    "spmm_ell",
    "spmm_ell_ad",
    "spmm_ell_dvals",
    "spmm_ell_dvals_reference",
    "spmm_ell_reference",
    "spmm_ell_streamed",
    "spmm_fused",
    "spmm_fused_reference",
    "spmm_hybrid",
    "spmm_hybrid_reference",
    "spmm_int8",
    "spmm_int8_reference",
    "spmm_reference",
    "spmm_subtile",
    "spmm_subtile_reference",
    "spmm_scipy",
    "spmm_streamed",
    "spmm_weighted",
    "spmm_weighted_ad",
    "spmm_weighted_dvalues",
    "spmm_weighted_dvalues_reference",
    "spmm_weighted_reference",
    "sddmm",
    "sddmm_ell",
    "sddmm_ell_ad",
    "scatter_lanes",
    "expand_bitmask",
]

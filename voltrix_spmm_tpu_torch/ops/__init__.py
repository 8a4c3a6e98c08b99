import torch

from .autodiff import spmm_ad
from .bitmask import expand_bitmask
from .block_spmm import spmm_block
from .fused_spmm import spmm_fused, spmm_fused_reference
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
from ..format.plan import SpmmPlan

IMPLS = ("auto", "pregather", "pallas", "fused", "weighted", "reference")


def _refuse_unported(plan) -> None:
    """Raise, naming the ROADMAP.md item, for plan kinds whose kernel the
    port does not have yet (the JAX dispatch is ops/__init__.py:68-132)."""
    if isinstance(plan, (list, tuple)):
        raise NotImplementedError(
            "window-chunk plan lists (format/stream.py) are ROADMAP.md item 10"
        )
    if not isinstance(plan, SpmmPlan):
        raise NotImplementedError(
            f"{type(plan).__name__} is not ported: EllPlan is ROADMAP.md item 12 "
            "(K6, K7), HybridPlan item 10"
        )
    if plan.config.seg_interleaved or plan.src_perm is not None:
        raise NotImplementedError(
            "seg_interleaved and pack_order='incidence' plans are TPU gather "
            "layouts the port does not take: ROADMAP.md item 18"
        )


def _refuse_tiling(block_d, slots, precision, compute_dtype) -> None:
    """The JAX package's TPU tiling and precision knobs: the H100 kernels
    pick their own tiles and compute in float32."""
    knobs = {"block_d": block_d, "slots": slots, "precision": precision}
    given = [k for k, v in knobs.items() if v is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: TPU tiling knobs; the H100 kernels' tiles and "
            "pipeline depth are for the H100 tuner, ROADMAP.md item 9"
        )
    if compute_dtype is not None and compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: the port's kernels compute in "
            "float32; bf16 streams are for the H100 tuner, ROADMAP.md item 9"
        )


def spmm(plan, feat, *, impl: str = "auto", subtile: bool = False, out_dtype=None,
         block_d=None, slots=None, precision=None, compute_dtype=None):
    """Public SpMM entry point: out = A @ feat.

    impl, as the JAX package dispatches it:
    - "auto": "fused" for coverage plans (gather_segment >= 8), else
      "pregather";
    - "pregather" / "pallas": kernel K1, or K2 with `subtile=True` (a
      clustered plan without it runs K1, as in JAX);
    - "fused": kernel K3;
    - "weighted": kernel K4, which "auto" picks for a plan with a value
      plane (K1, K2 and K3 raise ValueError on one);
    - "reference": the plain version: K4's for a weighted plan (the JAX
      package's oracle would drop the plane and return A @ feat).
    A CUDA tensor launches the kernel; a CPU tensor runs the kernel's
    plain version.

    feat may be (N, D) or graph-batched (B, N, D): the batch folds into
    the feature axis, so one launch serves the whole batch.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: the port has {', '.join(IMPLS)}")
    _refuse_unported(plan)
    _refuse_tiling(block_d, slots, precision, compute_dtype)
    if feat.dim() == 3:
        b, n, d = feat.shape
        flat = feat.permute(1, 0, 2).reshape(n, b * d)
        out = spmm(plan, flat, impl=impl, subtile=subtile, out_dtype=out_dtype)
        return out.reshape(-1, b, d).permute(1, 0, 2)
    weighted = plan.values is not None
    if impl == "auto":
        if weighted:
            impl = "weighted"
        else:
            impl = "fused" if plan.config.gather_segment >= 8 else "pregather"
    if impl == "weighted":
        return spmm_weighted(plan, feat, out_dtype)
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
    "spmm",
    "spmm_ad",
    "spmm_block",
    "spmm_fused",
    "spmm_fused_reference",
    "spmm_reference",
    "spmm_subtile",
    "spmm_subtile_reference",
    "spmm_scipy",
    "spmm_weighted",
    "spmm_weighted_ad",
    "spmm_weighted_dvalues",
    "spmm_weighted_dvalues_reference",
    "spmm_weighted_reference",
    "sddmm",
    "expand_bitmask",
]

from .autodiff import spmm_ad
from .bitmask import expand_bitmask
from .block_spmm import spmm_block
from .reference import spmm_reference, spmm_scipy
from ..format.plan import SpmmPlan


def _refuse_unported(plan, impl: str) -> None:
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
    if plan.values is not None:
        raise NotImplementedError(
            "weighted plans need kernel K4: ROADMAP.md item 11"
        )
    if plan.config.seg_interleaved or plan.src_perm is not None:
        raise NotImplementedError(
            "seg_interleaved and pack_order='incidence' plans are TPU gather "
            "layouts the port does not take: ROADMAP.md item 18"
        )
    if impl == "auto" and plan.config.gather_segment >= 8:
        raise NotImplementedError(
            "gather_segment >= 8 plans dispatch to the fused kernel K3: "
            "ROADMAP.md item 7 (impl='reference' runs the plain version)"
        )


def spmm(plan, feat, *, impl: str = "auto", out_dtype=None):
    """Public SpMM entry point: out = A @ feat.

    impl: "auto" runs kernel K1 on a CUDA tensor and its plain version on
    a CPU tensor; "reference" always runs the plain version.

    feat may be (N, D) or graph-batched (B, N, D): the batch folds into
    the feature axis, so one launch serves the whole batch.
    """
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}: the port has 'auto' and 'reference'")
    _refuse_unported(plan, impl)
    if feat.dim() == 3:
        b, n, d = feat.shape
        flat = feat.permute(1, 0, 2).reshape(n, b * d)
        out = spmm(plan, flat, impl=impl, out_dtype=out_dtype)
        return out.reshape(-1, b, d).permute(1, 0, 2)
    if impl == "reference":
        return spmm_reference(plan, feat, out_dtype)
    return spmm_block(plan, feat, out_dtype)


__all__ = [
    "spmm",
    "spmm_ad",
    "spmm_block",
    "spmm_reference",
    "spmm_scipy",
    "expand_bitmask",
]

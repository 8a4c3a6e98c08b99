"""Differentiable SpMM (counterpart of voltrix_spmm_tpu/ops/autodiff.py).

A is binary, so d/dX (A @ X) = A^T @ g: the backward is another SpMM,
over the transpose plan. For a symmetric adjacency the same plan serves
both directions.
"""

from __future__ import annotations

import torch

from ..format.hybrid import HybridPlan


def _dispatch(plan, feat: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The JAX package's rule (autodiff.py:20-49): coverage plans
    (gather_segment >= 8) run the fused kernel K3, column-clustered plans
    the subtile kernel K2, the rest K1; a HybridPlan runs `spmm_hybrid`;
    a list or tuple of window chunks dispatches each chunk by this rule
    and concatenates the rows (so a coverage chunk runs K3 here, where
    `spmm_streamed` runs K1). Each side of the gradient dispatches on its
    own plan, so `plan` and `plan_t` may be of different kinds.
    impl="reference" runs the plain versions instead."""
    from . import concat_chunks, spmm

    if isinstance(plan, (list, tuple)):
        return concat_chunks(plan, feat, lambda s: _dispatch(s, feat, impl))
    if isinstance(plan, HybridPlan):
        return spmm(plan, feat, impl=impl)
    return spmm(plan, feat, impl=impl, subtile=plan.config.cluster_cols)


def _has_values(plan) -> bool:
    if isinstance(plan, (list, tuple)):
        return any(_has_values(s) for s in plan)
    if isinstance(plan, HybridPlan):
        return _has_values(plan.dense) or _has_values(plan.sparse)
    return getattr(plan, "values", None) is not None


class _SpmmFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, plan, plan_t, impl):
        ctx.plan_t = plan_t
        ctx.impl = impl
        return _dispatch(plan, feat, impl)

    @staticmethod
    def backward(ctx, grad):
        return _dispatch(ctx.plan_t, grad.contiguous(), ctx.impl), None, None, None


def spmm_ad(plan, plan_t, feat: torch.Tensor, *, impl: str = "auto"):
    """SpMM with gradient support. `plan_t` must encode A^T (pass the same
    plan for a symmetric adjacency). Either may be an SpmmPlan, a
    HybridPlan or a list of window chunks (`format.stream`). Binary plans
    only, as in JAX: a weighted plan takes `spmm_weighted_ad`, which also
    differentiates the value plane."""
    if _has_values(plan) or _has_values(plan_t):
        raise ValueError("plan carries a value plane; use spmm_weighted_ad")
    return _SpmmFunction.apply(feat, plan, plan_t, impl)

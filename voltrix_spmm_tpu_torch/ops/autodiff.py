"""Differentiable SpMM (counterpart of voltrix_spmm_tpu/ops/autodiff.py).

A is binary, so d/dX (A @ X) = A^T @ g: the backward is another SpMM,
over the transpose plan. For a symmetric adjacency the same plan serves
both directions.
"""

from __future__ import annotations

import torch

from ..format.plan import SpmmPlan


def _dispatch(plan: SpmmPlan, feat: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The JAX package's rule (autodiff.py:45-49): coverage plans
    (gather_segment >= 8) run the fused kernel K3, column-clustered plans
    the subtile kernel K2, the rest K1. Each side of the gradient
    dispatches on its own plan, so `plan` and `plan_t` may be of
    different kinds. impl="reference" runs the plain version instead."""
    from . import spmm

    return spmm(plan, feat, impl=impl, subtile=plan.config.cluster_cols)


class _SpmmFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, plan, plan_t, impl):
        ctx.plan_t = plan_t
        ctx.impl = impl
        return _dispatch(plan, feat, impl)

    @staticmethod
    def backward(ctx, grad):
        return _dispatch(ctx.plan_t, grad.contiguous(), ctx.impl), None, None, None


def spmm_ad(plan: SpmmPlan, plan_t: SpmmPlan, feat: torch.Tensor, *, impl: str = "auto"):
    """SpMM with gradient support. `plan_t` must encode A^T (pass the same
    plan for a symmetric adjacency). Binary plans only, as in JAX: a
    weighted plan takes `spmm_weighted_ad`, which also differentiates the
    value plane."""
    if plan.values is not None or plan_t.values is not None:
        raise ValueError("plan carries a value plane; use spmm_weighted_ad")
    return _SpmmFunction.apply(feat, plan, plan_t, impl)

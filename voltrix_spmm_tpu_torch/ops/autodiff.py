"""Differentiable SpMM (counterpart of voltrix_spmm_tpu/ops/autodiff.py).

A is binary, so d/dX (A @ X) = A^T @ g: the backward is another SpMM,
over the transpose plan, through the same kernel K1. For a symmetric
adjacency the same plan serves both directions.
"""

from __future__ import annotations

import torch

from ..format.plan import SpmmPlan


class _SpmmFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, plan, plan_t, impl):
        from . import spmm

        ctx.plan_t = plan_t
        ctx.impl = impl
        return spmm(plan, feat, impl=impl)

    @staticmethod
    def backward(ctx, grad):
        from . import spmm

        return spmm(ctx.plan_t, grad.contiguous(), impl=ctx.impl), None, None, None


def spmm_ad(plan: SpmmPlan, plan_t: SpmmPlan, feat: torch.Tensor, *, impl: str = "auto"):
    """SpMM with gradient support. `plan_t` must encode A^T (pass the same
    plan for a symmetric adjacency)."""
    return _SpmmFunction.apply(feat, plan, plan_t, impl)

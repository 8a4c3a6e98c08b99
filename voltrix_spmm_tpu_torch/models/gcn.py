"""Two-layer GCN on the SpMM kernel (counterpart of
voltrix_spmm_tpu/models/gcn.py).

Weights keep the JAX package's layout, (in, out) used as ``x @ w``, so
parameters carry across unchanged (`gcn_params_from_jax`). Training is
`gcn_loss` and `make_train_step` over a torch.optim optimizer; the
backward of each aggregation is an SpMM over the transpose plan.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .graph import GraphData, aggregate

PARAM_NAMES = ("w1", "b1", "w2", "b2")


def _agg_linear(g, x, w, transform_first, impl):
    """agg(x) @ w in the cheaper order. Aggregation is linear, so
    agg(x) @ w == agg(x @ w) up to float association; "auto" transforms
    first only when in_dim > 256 and the output is narrower, the JAX
    package's rule (models/gcn.py:43-47), so both take the same order."""
    if transform_first == "auto":
        transform_first = x.shape[-1] > 256 and w.shape[1] < x.shape[-1]
    if transform_first:
        return aggregate(g, x @ w, mode="mean", impl=impl)
    return aggregate(g, x, mode="mean", impl=impl) @ w


def gcn_forward(
    params: Mapping[str, torch.Tensor],
    g: GraphData,
    x: torch.Tensor,
    *,
    transform_first="auto",
    impl: str = "auto",
) -> torch.Tensor:
    """logits = agg(relu(agg(x) @ W1 + b1)) @ W2 + b2, mean aggregation.

    impl: "auto" aggregates through the plan's kernel on the card (K1,
    K2 or K3, see ops.autodiff); "reference" through the plain version."""
    h = torch.relu(_agg_linear(g, x, params["w1"], transform_first, impl) + params["b1"])
    return _agg_linear(g, h, params["w2"], transform_first, impl) + params["b2"]


def gcn_loss(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor,
             labels: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the GCN's logits against integer
    labels (the JAX package's gcn_loss)."""
    return F.cross_entropy(gcn_forward(params, g, x, impl=impl), labels)


def make_train_step(optimizer: torch.optim.Optimizer, loss_fn=gcn_loss):
    """The counterpart of the JAX package's make_train_step: returns
    `train_step(params, g, x, y, *, impl="auto") -> loss`, one full step
    that zeroes the gradients, runs `loss_fn` forward and backward, and
    steps `optimizer`, which holds the tensors of `params` (a mapping such
    as `GCN.params()`). The parameters are updated in place; after the
    call their `.grad` holds the step's gradients."""

    def train_step(params, g, x, y, *, impl: str = "auto") -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, g, x, y, impl=impl)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def gcn_params_from_jax(params: Mapping[str, np.ndarray], device="cuda") -> dict:
    """The JAX package's `init_gcn` parameters (or any mapping of arrays
    in its layout) as float32 tensors on `device`."""
    return {
        name: torch.tensor(np.asarray(params[name]), dtype=torch.float32, device=device)
        for name in PARAM_NAMES
    }


class GCN(nn.Module):
    """Two-layer GCN with parameters w1 (in, hidden), b1, w2 (hidden,
    classes), b2, initialised as the JAX package's `init_gcn` does (He
    normal weights, zero biases), from a torch.Generator (drawn on the
    CPU, then moved to `device`)."""

    def __init__(
        self,
        in_dim: int,
        hidden: int,
        num_classes: int,
        *,
        generator: torch.Generator | None = None,
        device="cuda",
    ):
        super().__init__()

        def normal(rows, cols):
            w = torch.randn(rows, cols, generator=generator)
            return nn.Parameter((w * (2.0 / rows) ** 0.5).to(device))

        self.w1 = normal(in_dim, hidden)
        self.b1 = nn.Parameter(torch.zeros(hidden, device=device))
        self.w2 = normal(hidden, num_classes)
        self.b2 = nn.Parameter(torch.zeros(num_classes, device=device))

    @classmethod
    def from_params(cls, params: Mapping[str, torch.Tensor]) -> "GCN":
        in_dim, hidden = params["w1"].shape
        model = cls(in_dim, hidden, params["w2"].shape[1], device="meta")
        for name in PARAM_NAMES:
            setattr(model, name, nn.Parameter(params[name].detach().clone()))
        return model

    def params(self) -> dict:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, g: GraphData, x: torch.Tensor, *, transform_first="auto", impl="auto"):
        return gcn_forward(self.params(), g, x, transform_first=transform_first, impl=impl)

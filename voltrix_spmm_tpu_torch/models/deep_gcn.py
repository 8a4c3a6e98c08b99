"""Deep (L-layer) residual GCN with optional per-layer recomputation
(counterpart of voltrix_spmm_tpu/models/deep_gcn.py).

An input layer, L - 2 uniform hidden layers h <- h + relu(agg(h) @ W + b)
(the residual keeps deep stacks trainable) and an output layer. The
hidden layers' weights stay stacked as in the JAX package, w_mid (L - 2,
hidden, hidden) and b_mid (L - 2, hidden), so parameters carry across;
JAX's `lax.scan` over them is a Python loop here.

remat=True runs each hidden layer under `torch.utils.checkpoint`
(use_reentrant=False, JAX's `jax.checkpoint`): the backward recomputes
the layer's aggregate, pre-activation and relu instead of keeping them,
one more aggregation (K1 launch on a default plan) per hidden layer and
step, in exchange for those buffers. Each layer's input is kept either
way. Whether that lowers the step's peak memory on a given graph is
measured, not assumed (chip_smoke.py's path K prints both).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax

PARAM_NAMES = ("w_in", "b_in", "w_mid", "b_mid", "w_out", "b_out")


def deep_gcn_forward(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor, *,
                     remat: bool = False, residual: bool = True, mode: str = "mean",
                     impl: str = "auto") -> torch.Tensor:
    """Logits of the L-layer GCN (L = w_mid.shape[0] + 2). impl: "auto"
    (the plan's kernel) or "reference" (its plain version)."""
    h = torch.relu(aggregate(g, x, mode=mode, impl=impl) @ params["w_in"] + params["b_in"])

    def body(carry, w, b):
        out = torch.relu(aggregate(g, carry, mode=mode, impl=impl) @ w + b)
        return out + carry if residual else out

    for w, b in zip(params["w_mid"], params["b_mid"]):
        h = checkpoint(body, h, w, b, use_reentrant=False) if remat else body(h, w, b)
    h = aggregate(g, h, mode=mode, impl=impl)
    return h @ params["w_out"] + params["b_out"]


def deep_gcn_loss(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor,
                  y: torch.Tensor, *, remat: bool = False, residual: bool = True,
                  mode: str = "mean", impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the deep GCN's logits."""
    logits = deep_gcn_forward(params, g, x, remat=remat, residual=residual, mode=mode, impl=impl)
    return F.cross_entropy(logits, y)


def make_deep_train_step(optimizer: torch.optim.Optimizer, *, remat: bool = False,
                         residual: bool = True, mode: str = "mean"):
    """The counterpart of the JAX package's make_deep_train_step: returns
    `step(params, g, x, y, *, impl="auto") -> loss`, one full-graph step
    that zeroes the gradients, runs `deep_gcn_loss` forward and backward
    and steps `optimizer`, which holds the tensors of `params` (as
    `DeepGCN.params()`); the parameters are updated in place."""

    def step(params, g, x, y, *, impl: str = "auto") -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = deep_gcn_loss(params, g, x, y, remat=remat, residual=residual, mode=mode,
                             impl=impl)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def deep_gcn_params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's `init_deep_gcn` parameters as float32 tensors on `device`."""
    return params_from_jax({k: params[k] for k in PARAM_NAMES}, device)


class DeepGCN(ParamTree):
    """The L-layer GCN (num_layers >= 2) initialised as `init_deep_gcn`
    does (He normal weights, zero biases), from a torch.Generator."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, num_layers: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if num_layers < 2:
            raise ValueError(f"need at least the input and output layers, got {num_layers}")
        s_h = (2.0 / hidden) ** 0.5
        self._set_tree({
            "w_in": normal(generator, (in_dim, hidden), (2.0 / in_dim) ** 0.5, device),
            "b_in": torch.zeros(hidden, device=device),
            "w_mid": normal(generator, (num_layers - 2, hidden, hidden), s_h, device),
            "b_mid": torch.zeros(num_layers - 2, hidden, device=device),
            "w_out": normal(generator, (hidden, num_classes), s_h, device),
            "b_out": torch.zeros(num_classes, device=device),
        })

    def forward(self, g: GraphData, x: torch.Tensor, *, remat: bool = False,
                residual: bool = True, mode: str = "mean", impl: str = "auto") -> torch.Tensor:
        return deep_gcn_forward(self.params(), g, x, remat=remat, residual=residual, mode=mode,
                                impl=impl)

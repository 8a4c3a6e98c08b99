"""GIN (graph isomorphism network) on the SpMM kernel (counterpart of
voltrix_spmm_tpu/models/gin.py).

h' = MLP((1 + eps) * h + sum_neighbours h), with a learned eps per layer:
sum aggregation is the binary SpMM itself, one `aggregate(..., "sum")`
per layer.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax

PARAM_NAMES = ("eps1", "w1a", "b1a", "w1b", "b1b", "eps2", "w2a", "b2a", "w2b", "b2b")


def _gin_layer(x, agg, eps, wa, ba, wb, bb):
    h = (1.0 + eps) * x + agg
    h = torch.relu(h @ wa + ba)
    return h @ wb + bb


def gin_forward(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """Class logits of the two-layer GIN. impl: "auto" (the plan's kernel)
    or "reference" (its plain version)."""
    p = params
    a1 = aggregate(g, x, mode="sum", impl=impl)
    h = torch.relu(_gin_layer(x, a1, p["eps1"], p["w1a"], p["b1a"], p["w1b"], p["b1b"]))
    a2 = aggregate(g, h, mode="sum", impl=impl)
    return _gin_layer(h, a2, p["eps2"], p["w2a"], p["b2a"], p["w2b"], p["b2b"])


def gin_params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's `init_gin` parameters as float32 tensors on `device`."""
    return params_from_jax({k: params[k] for k in PARAM_NAMES}, device)


class GIN(ParamTree):
    """Two-layer GIN initialised as `init_gin` does (He normal weights,
    zero biases and eps), from a torch.Generator."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        s1, s2 = (2.0 / in_dim) ** 0.5, (2.0 / hidden) ** 0.5

        def zeros(*shape):
            return torch.zeros(*shape, device=device)

        self._set_tree({
            "eps1": zeros(()), "w1a": normal(generator, (in_dim, hidden), s1, device),
            "b1a": zeros(hidden), "w1b": normal(generator, (hidden, hidden), s2, device),
            "b1b": zeros(hidden), "eps2": zeros(()),
            "w2a": normal(generator, (hidden, hidden), s2, device), "b2a": zeros(hidden),
            "w2b": normal(generator, (hidden, num_classes), s2, device),
            "b2b": zeros(num_classes),
        })

    def forward(self, g: GraphData, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return gin_forward(self.params(), g, x, impl=impl)

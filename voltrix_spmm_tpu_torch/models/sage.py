"""GraphSAGE, mean aggregator, on the SpMM kernel (counterpart of
voltrix_spmm_tpu/models/sage.py).

h = relu(x @ W_self1 + mean_agg(x) @ W_neigh1 + b1), then the same layer
to class logits without the relu. Each aggregation is one `aggregate`
call (K1 on a default plan on the card; its backward K1 over the
transpose plan).
"""

from __future__ import annotations

from typing import Mapping

import torch

from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax

PARAM_NAMES = ("w_self1", "w_neigh1", "b1", "w_self2", "w_neigh2", "b2")


def sage_forward(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """Class logits of the two-layer SAGE. impl: "auto" (the plan's kernel)
    or "reference" (its plain version)."""
    agg = aggregate(g, x, mode="mean", impl=impl)
    h = torch.relu(x @ params["w_self1"] + agg @ params["w_neigh1"] + params["b1"])
    agg2 = aggregate(g, h, mode="mean", impl=impl)
    return h @ params["w_self2"] + agg2 @ params["w_neigh2"] + params["b2"]


def sage_params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's `init_sage` parameters as float32 tensors on `device`."""
    return params_from_jax({k: params[k] for k in PARAM_NAMES}, device)


class SAGE(ParamTree):
    """Two-layer SAGE initialised as `init_sage` does (normal weights
    scaled by sqrt(1 / fan_in), zero biases), from a torch.Generator."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        s1, s2 = (1.0 / in_dim) ** 0.5, (1.0 / hidden) ** 0.5
        self._set_tree({
            "w_self1": normal(generator, (in_dim, hidden), s1, device),
            "w_neigh1": normal(generator, (in_dim, hidden), s1, device),
            "b1": torch.zeros(hidden, device=device),
            "w_self2": normal(generator, (hidden, num_classes), s2, device),
            "w_neigh2": normal(generator, (hidden, num_classes), s2, device),
            "b2": torch.zeros(num_classes, device=device),
        })

    def forward(self, g: GraphData, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return sage_forward(self.params(), g, x, impl=impl)

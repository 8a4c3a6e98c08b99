"""APPNP (Klicpera et al., ICLR 2019) on the SpMM kernel (counterpart of
voltrix_spmm_tpu/models/appnp.py).

A two-layer MLP, then K steps of personalised-PageRank propagation

    z^{k+1} = (1 - alpha) * A_hat @ z^k + alpha * h,   A_hat = D^-1/2 A D^-1/2

each one `aggregate(..., "sym")` on the same plan: K back-to-back SpMMs
(K1 on a default plan on the card). JAX's `lax.fori_loop` is a Python
loop here; the backward runs the K steps' transposes in reverse.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax

PARAM_NAMES = ("w1", "b1", "w2", "b2")


def appnp_forward(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor, *,
                  k: int = 10, alpha: float = 0.1, impl: str = "auto") -> torch.Tensor:
    """Logits after K propagation steps. impl: "auto" (the plan's kernel)
    or "reference" (its plain version)."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    h = h @ params["w2"] + params["b2"]
    z = h
    for _ in range(k):
        z = (1.0 - alpha) * aggregate(g, z, mode="sym", impl=impl) + alpha * h
    return z


def appnp_loss(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor,
               labels: torch.Tensor, *, k: int = 10, alpha: float = 0.1,
               impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of APPNP's logits against integer labels."""
    return F.cross_entropy(appnp_forward(params, g, x, k=k, alpha=alpha, impl=impl), labels)


def appnp_params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's `init_appnp` parameters as float32 tensors on `device`."""
    return params_from_jax({k: params[k] for k in PARAM_NAMES}, device)


class APPNP(ParamTree):
    """APPNP's MLP initialised as `init_appnp` does (He normal weights,
    zero biases), from a torch.Generator."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self._set_tree({
            "w1": normal(generator, (in_dim, hidden), (2.0 / in_dim) ** 0.5, device),
            "b1": torch.zeros(hidden, device=device),
            "w2": normal(generator, (hidden, num_classes), (2.0 / hidden) ** 0.5, device),
            "b2": torch.zeros(num_classes, device=device),
        })

    def forward(self, g: GraphData, x: torch.Tensor, *, k: int = 10, alpha: float = 0.1,
                impl: str = "auto") -> torch.Tensor:
        return appnp_forward(self.params(), g, x, k=k, alpha=alpha, impl=impl)

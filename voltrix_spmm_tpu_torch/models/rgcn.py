"""R-GCN (relational GCN) on the SpMM kernel (counterpart of
voltrix_spmm_tpu/models/rgcn.py).

Edges carry relation types, and a layer aggregates once per relation
with that relation's weight:

    h' = act(h @ W_self + b + sum_r mean_agg_r(h) @ W_r)

Each relation is a `GraphData` of its own, usually directed, so with its
own transpose plan (`build_graph(..., symmetric=False)`): a layer is R
SpMMs (K1 on default plans on the card). With num_bases=B the relation
weights are the basis decomposition W_r = sum_b a[r, b] V_b of the R-GCN
paper. Label -100 (any negative label) leaves a node out of the loss.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax


def _rel_weights(layer: Mapping[str, torch.Tensor]) -> torch.Tensor:
    if "w_rel" in layer:
        return layer["w_rel"]
    # basis decomposition: W_r = sum_b a[r, b] V_b
    return torch.einsum("rb,bio->rio", layer["a_coef"], layer["v_bases"])


def _rgcn_layer(layer, rel_graphs, h, impl):
    w_rel = _rel_weights(layer)
    z = h @ layer["w_self"] + layer["b"]
    for r, g in enumerate(rel_graphs):
        z = z + aggregate(g, h, mode="mean", impl=impl) @ w_rel[r]
    return z


def rgcn_forward(params, rel_graphs: list[GraphData], x: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """Logits of the two R-GCN layers over `rel_graphs`, one per relation.
    impl: "auto" (the plans' kernels) or "reference" (the plain version)."""
    h = torch.relu(_rgcn_layer(params["layers"][0], rel_graphs, x, impl))
    return _rgcn_layer(params["layers"][1], rel_graphs, h, impl)


def rgcn_loss(params, rel_graphs: list[GraphData], x: torch.Tensor, labels: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy over the nodes with a label >= 0 (0 when
    there is none), as the JAX package's rgcn_loss masks label -100."""
    logits = rgcn_forward(params, rel_graphs, x, impl=impl)
    mask = labels >= 0
    losses = F.cross_entropy(logits, labels.clamp_min(0), reduction="none")
    return torch.where(mask, losses, 0.0).sum() / mask.sum().clamp_min(1)


def make_rgcn_train_step(optimizer: torch.optim.Optimizer):
    """The counterpart of the JAX package's make_rgcn_train_step: returns
    `step(params, rel_graphs, x, y, *, impl="auto") -> loss`, one step that
    zeroes the gradients, runs `rgcn_loss` forward and backward and steps
    `optimizer`, which holds the tensors of `params` (as `RGCN.params()`)."""

    def step(params, rel_graphs, x, y, *, impl: str = "auto") -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = rgcn_loss(params, rel_graphs, x, y, impl=impl)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def rgcn_params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's `init_rgcn` parameters ({"layers": [layer, layer]},
    with w_rel, or v_bases and a_coef) as float32 tensors on `device`."""
    return params_from_jax({"layers": list(params["layers"])}, device)


class RGCN(ParamTree):
    """Two R-GCN layers initialised as `init_rgcn` does (normal weights
    scaled by sqrt(1 / fan_in), coefficients by sqrt(1 / num_bases), zero
    biases), from a torch.Generator. num_bases=None keeps a full W_r per
    relation; an int B keeps B shared bases and (R, B) coefficients."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, num_rels: int,
                 num_bases: int | None = None, *, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        layers = []
        for a, b in ((in_dim, hidden), (hidden, num_classes)):
            s = (1.0 / a) ** 0.5
            layer = {"w_self": normal(generator, (a, b), s, device),
                     "b": torch.zeros(b, device=device)}
            if num_bases is None:
                layer["w_rel"] = normal(generator, (num_rels, a, b), s, device)
            else:
                layer["v_bases"] = normal(generator, (num_bases, a, b), s, device)
                layer["a_coef"] = normal(generator, (num_rels, num_bases),
                                         (1.0 / num_bases) ** 0.5, device)
            layers.append(layer)
        self._set_tree({"layers": layers})

    def forward(self, rel_graphs: list[GraphData], x: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
        return rgcn_forward(self.params(), rel_graphs, x, impl=impl)

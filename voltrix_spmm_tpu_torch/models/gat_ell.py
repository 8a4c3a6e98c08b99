"""Dot-product-attention GAT on the edge-per-lane (ELL) plan (counterpart
of voltrix_spmm_tpu/models/gat_ell.py).

Per head:

1. scores e_uv = leaky_relu(scale * q_u . k_v, 0.2) from the
   differentiable SDDMM `sddmm_ell_ad` (kernel K7; backward two K6);
2. the softmax over each node's incoming edges, `models.gat.edge_softmax`
   (O(nnz) plain torch, the graph carries the same `rows` / `num_nodes`);
3. the attention vector placed on the lanes of A and A^T by
   `format.lane_values` (a gather), and the aggregation `spmm_ell_ad`
   (K6 forward; backward K6 over A^T for v and K7 for the attention).

Values cost 4 bytes per edge, against a dense (block_h, block_w) tile per
block on the weighted `SpmmPlan` of models/gat.py. Parameters keep the JAX
package's layouts: wq1, wk1, wv1 (heads, in, hidden); wq2, wk2, wv2
(heads * hidden, classes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..format.ell import EllPlan, build_ell_pair, lane_values
from ..format.plan import PlanConfig
from ..ops.ell import sddmm_ell_ad, spmm_ell_ad
from .gat import edge_softmax

PARAM_NAMES = ("wq1", "wk1", "wv1", "wq2", "wk2", "wv2")


@dataclass
class EllGraph:
    """ELL plans for A and A^T (edge maps in A's CSR order) and the edge
    endpoints the softmax needs."""

    plan: EllPlan
    plan_t: EllPlan
    rows: torch.Tensor  # int64 (nnz,) edge destination (the aggregating node)
    cols: torch.Tensor  # int64 (nnz,) edge source (the neighbour)
    num_nodes: int


def build_ell_graph(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig = PlanConfig(128, 128),
    device="cuda",
) -> EllGraph:
    """Plans for A and A^T (`build_ell_pair`) and the edge endpoints,
    moved to `device` (the card unless the caller asks for the CPU) once."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    plan, plan_t = build_ell_pair(indptr, indices, num_nodes, config=config)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    return EllGraph(
        plan=plan.to(device),
        plan_t=plan_t.to(device),
        rows=torch.from_numpy(rows).to(device),
        cols=torch.from_numpy(np.ascontiguousarray(indices)).to(device),
        num_nodes=num_nodes,
    )


def dot_attention_aggregate(g: EllGraph, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            negative_slope: float = 0.2, scale: float | None = None,
                            impl: str = "auto") -> torch.Tensor:
    """One attention head: out_u = sum_v softmax_v(leaky_relu(scale * q_u .
    k_v)) v_v over u's in-neighbours (scale defaults to 1 / sqrt(width)).

    A^T's lanes are read only by the gradient of v, so they are built only
    when autograd records the call."""
    if scale is None:
        scale = 1.0 / float(q.shape[1]) ** 0.5
    e = sddmm_ell_ad(g.plan, g.plan_t, q.contiguous(), k.contiguous(), impl=impl) * scale
    alpha = edge_softmax(g, F.leaky_relu(e, negative_slope=negative_slope))
    plan = dataclasses.replace(g.plan, vals=lane_values(g.plan, alpha))
    plan_t = None
    if torch.is_grad_enabled():
        plan_t = dataclasses.replace(g.plan_t, vals=lane_values(g.plan_t, alpha))
    return spmm_ell_ad(plan, plan_t, v.contiguous(), impl=impl)


def gat_dot_forward(params: Mapping[str, torch.Tensor], g: EllGraph, x: torch.Tensor, *,
                    impl: str = "auto") -> torch.Tensor:
    """logits = head2(elu(concat_h head1_h(x))). impl: "auto" runs K6 and
    K7 on the card, "reference" their plain versions."""
    heads = [
        dot_attention_aggregate(g, x @ params["wq1"][h], x @ params["wk1"][h],
                                x @ params["wv1"][h], impl=impl)
        for h in range(params["wq1"].shape[0])
    ]
    h = F.elu(torch.cat(heads, dim=1))
    return dot_attention_aggregate(g, h @ params["wq2"], h @ params["wk2"], h @ params["wv2"],
                                   impl=impl)


def gat_dot_loss(params: Mapping[str, torch.Tensor], g: EllGraph, x: torch.Tensor,
                 labels: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the logits (the JAX package's
    gat_dot_loss); takes `make_train_step` as its loss."""
    return F.cross_entropy(gat_dot_forward(params, g, x, impl=impl), labels)


def gat_dot_params_from_jax(params: Mapping[str, np.ndarray], device="cuda") -> dict:
    """The JAX package's `init_gat_dot` parameters (or any mapping of
    arrays in its layout) as float32 tensors on `device`."""
    return {
        name: torch.tensor(np.asarray(params[name]), dtype=torch.float32, device=device)
        for name in PARAM_NAMES
    }


class GATDot(nn.Module):
    """Two-layer dot-product GAT: num_heads concatenated heads with their
    own q, k, v projections, ELU, then one head producing class logits.
    Initialised as the JAX package's `init_gat_dot` (normal weights scaled
    by sqrt(2 / fan_in)), from a torch.Generator drawn on the CPU, then
    moved to `device`."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, num_heads: int = 4, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()

        def normal(shape, fan_in):
            w = torch.randn(*shape, generator=generator) * (2.0 / fan_in) ** 0.5
            return nn.Parameter(w.to(device))

        h2 = num_heads * hidden
        for name in ("wq1", "wk1", "wv1"):
            setattr(self, name, normal((num_heads, in_dim, hidden), in_dim))
        for name in ("wq2", "wk2", "wv2"):
            setattr(self, name, normal((h2, num_classes), h2))

    @classmethod
    def from_params(cls, params: Mapping[str, torch.Tensor]) -> "GATDot":
        heads, in_dim, hidden = params["wq1"].shape
        model = cls(in_dim, hidden, params["wq2"].shape[1], heads, device="meta")
        for name in PARAM_NAMES:
            setattr(model, name, nn.Parameter(params[name].detach().clone()))
        return model

    def params(self) -> dict:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, g: EllGraph, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return gat_dot_forward(self.params(), g, x, impl=impl)

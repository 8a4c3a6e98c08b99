"""Graph Attention Network on the weighted SpMM (counterpart of
voltrix_spmm_tpu/models/gat.py).

Per head:

1. edge logits e_uv = leaky_relu(a_src . h_u + a_dst . h_v, 0.2) and a
   softmax over each node's incoming edges (`edge_softmax`): O(nnz) work
   in plain torch;
2. the (nnz,) attention vector is scattered into the value planes of A
   and A^T through the static maps of `format.edge_slot_map`
   (`index_add_`, so gradients flow back to the edges);
3. the aggregation runs `spmm_weighted_ad`: kernel K4 forward, and in the
   backward K4 over the transpose plane for the features and K5 for the
   attention.

Parameters keep the JAX package's layouts: w1 (heads, in, hidden), a1_src
and a1_dst (heads, hidden), w2 (heads * hidden, classes), a2_src and
a2_dst (classes,). Each value plane costs total_blocks * block_h *
block_w * 4 bytes, so GAT graphs want short windows (the default
PlanConfig(64, 128)).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..format.plan import PlanConfig, SpmmPlan
from ..format.preprocess import csr_preprocess, csr_transpose, edge_slot_map
from ..ops.weighted import spmm_weighted_ad

PARAM_NAMES = ("w1", "a1_src", "a1_dst", "w2", "a2_src", "a2_dst")


@dataclass
class GatGraph:
    """Plans for A and A^T and the static edge -> slot scatter maps."""

    plan: SpmmPlan  # binary; the value plane is scattered in per forward
    plan_t: SpmmPlan
    slots: torch.Tensor  # int64 (nnz,) flat index into plan's plane
    slots_t: torch.Tensor  # int64 (nnz,) flat index into plan_t's plane
    rows: torch.Tensor  # int64 (nnz,) edge destination (the aggregating node)
    cols: torch.Tensor  # int64 (nnz,) edge source (the neighbour)
    num_nodes: int


def build_gat_graph(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig = PlanConfig(64, 128),
    device="cuda",
) -> GatGraph:
    """Plans for A and A^T (binary: the planes are rebuilt from the
    attention at every forward) and the edge -> slot maps, moved to
    `device` (the card unless the caller asks for the CPU) once."""
    if config.gather_segment != 1 or config.cluster_cols:
        raise ValueError("GAT needs exact-lane plans (the value plane rides the bitmask)")
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    plan = csr_preprocess(indptr, indices, num_nodes, config)
    ptr_t, idx_t, _ = csr_transpose(indptr, indices, num_nodes)
    plan_t = csr_preprocess(ptr_t, idx_t, num_nodes, config)
    for p in (plan, plan_t):
        size = p.total_blocks * config.block_h * config.block_w
        if size > np.iinfo(np.int32).max:
            raise ValueError(
                f"GAT value plane has {size} slots, beyond the int32 slot indices "
                "the JAX package uses: take a shorter window height or partition "
                "the graph"
            )
    slots = edge_slot_map(plan, indptr, indices)
    # the transpose edge (v, u) carries the same attention as (u, v): map
    # each transpose-CSR position back to its original edge
    order = np.argsort(indices, kind="stable")
    slots_t = np.empty_like(slots)
    slots_t[order] = edge_slot_map(plan_t, ptr_t, idx_t)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return GatGraph(
        plan=plan.to(device),
        plan_t=plan_t.to(device),
        slots=tensor(slots),
        slots_t=tensor(slots_t),
        rows=tensor(rows),
        cols=tensor(indices),
        num_nodes=num_nodes,
    )


def edge_softmax(g: GatGraph, e: torch.Tensor) -> torch.Tensor:
    """Softmax over each node's incoming edges, (nnz,) -> (nnz,).

    The softmax does not depend on the shift m, so no gradient is taken
    through it (JAX's segment_max passes terms that cancel). Per-node
    values reach the edges through `index_select`, whose backward is an
    `index_add_`: the backward of `x[rows]` sorts the indices and
    serialises a hub node's tens of thousands of edges."""
    m = e.new_zeros(g.num_nodes).scatter_reduce(0, g.rows, e.detach(), "amax",
                                                include_self=False)
    alpha = torch.exp(e - m.index_select(0, g.rows))
    denom = alpha.new_zeros(g.num_nodes).index_add(0, g.rows, alpha)
    return alpha / denom.index_select(0, g.rows).clamp_min(1e-9)


def _scatter_plane(plan: SpmmPlan, slots: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    cfg = plan.config
    shape = (plan.total_blocks, cfg.block_h, cfg.block_w)
    plane = alpha.new_zeros(shape[0] * shape[1] * shape[2])
    return plane.index_add_(0, slots, alpha).view(shape)


def gat_attention_aggregate(g: GatGraph, h: torch.Tensor, a_src: torch.Tensor,
                            a_dst: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """One attention head: out_u = sum_v alpha_uv h_v over u's neighbours.

    The transpose plane is read only by the feature gradient, so it is
    built only when autograd records the call; without it (under
    torch.no_grad()) the logits are the same."""
    s = h @ a_src  # (N,) destination-side logits
    t = h @ a_dst  # (N,) source-side logits
    e = F.leaky_relu(s.index_select(0, g.rows) + t.index_select(0, g.cols), negative_slope=0.2)
    alpha = edge_softmax(g, e)
    plane = _scatter_plane(g.plan, g.slots, alpha)
    plane_t = _scatter_plane(g.plan_t, g.slots_t, alpha) if torch.is_grad_enabled() else None
    return spmm_weighted_ad(
        dataclasses.replace(g.plan, values=plane),
        dataclasses.replace(g.plan_t, values=plane_t),
        h,
        impl=impl,
    )


def gat_forward(params: Mapping[str, torch.Tensor], g: GatGraph, x: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """logits = head2(elu(concat_k head1_k(x))). impl: "auto" runs K4/K5
    on the card, "reference" their plain versions."""
    heads = [
        gat_attention_aggregate(g, x @ params["w1"][k], params["a1_src"][k],
                                params["a1_dst"][k], impl=impl)
        for k in range(params["w1"].shape[0])
    ]
    h = F.elu(torch.cat(heads, dim=1))
    return gat_attention_aggregate(g, h @ params["w2"], params["a2_src"], params["a2_dst"],
                                   impl=impl)


def gat_loss(params: Mapping[str, torch.Tensor], g: GatGraph, x: torch.Tensor,
             labels: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the GAT's logits (the JAX package's
    gat_loss)."""
    return F.cross_entropy(gat_forward(params, g, x, impl=impl), labels)


def gat_params_from_jax(params: Mapping[str, np.ndarray], device="cuda") -> dict:
    """The JAX package's `init_gat` parameters (or any mapping of arrays in
    its layout) as float32 tensors on `device`."""
    return {
        name: torch.tensor(np.asarray(params[name]), dtype=torch.float32, device=device)
        for name in PARAM_NAMES
    }


class GAT(nn.Module):
    """Two-layer GAT (Velickovic et al. 2018): num_heads concatenated
    heads, ELU, then one head producing class logits. Initialised as the
    JAX package's `init_gat` (normal weights scaled by sqrt(2 / fan_in),
    attention vectors by 1 / sqrt(width)), from a torch.Generator drawn
    on the CPU, then moved to `device`."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, num_heads: int = 4, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()

        def normal(shape, scale):
            w = torch.randn(*shape, generator=generator) * scale
            return nn.Parameter(w.to(device))

        self.w1 = normal((num_heads, in_dim, hidden), (2.0 / in_dim) ** 0.5)
        self.a1_src = normal((num_heads, hidden), hidden ** -0.5)
        self.a1_dst = normal((num_heads, hidden), hidden ** -0.5)
        self.w2 = normal((num_heads * hidden, num_classes), (2.0 / (num_heads * hidden)) ** 0.5)
        self.a2_src = normal((num_classes,), num_classes ** -0.5)
        self.a2_dst = normal((num_classes,), num_classes ** -0.5)

    @classmethod
    def from_params(cls, params: Mapping[str, torch.Tensor]) -> "GAT":
        heads, in_dim, hidden = params["w1"].shape
        model = cls(in_dim, hidden, params["w2"].shape[1], heads, device="meta")
        for name in PARAM_NAMES:
            setattr(model, name, nn.Parameter(params[name].detach().clone()))
        return model

    def params(self) -> dict:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, g: GatGraph, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return gat_forward(self.params(), g, x, impl=impl)

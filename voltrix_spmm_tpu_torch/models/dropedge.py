"""DropEdge (Rong et al., ICLR 2020): per-edge dropout on the weighted
SpMM (counterpart of voltrix_spmm_tpu/models/dropedge.py).

A Bernoulli keep mask over the edges becomes value planes of A and A^T
through the static edge -> slot maps of `format.edge_slot_map` (one
O(nnz) scatter a call, no plan rebuild), and the aggregation is the
weighted SpMM with values in {0, 1/keep_prob}, unbiased in expectation:
kernel K4 forward and, in the backward, K4 over the transpose plane (the
planes need no gradient, so K5 is not launched).

The mask is drawn by `torch.bernoulli` on the caller's generator, so it
is not the mask JAX's `jax.random.bernoulli` draws; the same generator
state gives the same mask. The planes are built by `models.gat`'s
scatter (`index_add_` onto zeros): a slot shared by duplicate CSR edges
receives only equal addends (0 or 1/keep_prob each), whose sum does not
depend on the order, so a plane repeats bit for bit.

At eval (deterministic=True or keep_prob >= 1) a graph without duplicate
edges takes the binary SpMM (K1), since all-ones weights are the binary
aggregation; with duplicates it keeps the weighted path, so each edge
counts as often as it appears, as the training path's scatter sums it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..format.plan import PlanConfig, SpmmPlan
from ..format.preprocess import csr_preprocess, csr_transpose, edge_slot_map
from ..ops.autodiff import spmm_ad
from ..ops.weighted import spmm_weighted_ad
from .gat import _scatter_plane


@dataclass
class DropEdgeGraph:
    plan: SpmmPlan  # binary; the value plane is scattered in per call
    plan_t: SpmmPlan
    slots: torch.Tensor  # int64 (nnz,) edge -> flat slot of plan's plane
    slots_t: torch.Tensor  # int64 (nnz,) edge -> flat slot of plan_t's plane
    num_edges: int
    # duplicate (row, col) CSR edges share a slot: the scatter sums them
    # (coefficient = multiplicity) where the bitmask counts them once, so
    # the eval fast path holds only without duplicates
    has_duplicate_edges: bool = False


def build_dropedge_graph(indptr, indices, num_nodes: int,
                         config: PlanConfig = PlanConfig(64, 128),
                         device="cuda") -> DropEdgeGraph:
    """Plans for A and A^T and the edge -> slot maps, moved to `device`
    (the card unless the caller asks for the CPU) once."""
    if config.gather_segment != 1 or config.cluster_cols:
        raise ValueError("DropEdge needs exact-lane plans (the value plane rides the bitmask)")
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    plan = csr_preprocess(indptr, indices, num_nodes, config)
    ptr_t, idx_t, _ = csr_transpose(indptr, indices, num_nodes)
    plan_t = csr_preprocess(ptr_t, idx_t, num_nodes, config)
    slots = edge_slot_map(plan, indptr, indices)
    # the transpose edge (v, u) carries (u, v)'s weight
    order = np.argsort(indices, kind="stable")
    slots_t = np.empty_like(slots)
    slots_t[order] = edge_slot_map(plan_t, ptr_t, idx_t)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return DropEdgeGraph(
        plan=plan.to(device),
        plan_t=plan_t.to(device),
        slots=tensor(slots),
        slots_t=tensor(slots_t),
        num_edges=int(indices.shape[0]),
        has_duplicate_edges=bool(np.unique(slots).size != slots.size),
    )


def dropedge_weights(num_edges: int, keep_prob: float, generator: torch.Generator | None,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """The per-edge weights of one training call: keep / keep_prob, keep
    drawn by torch.bernoulli(keep_prob) on `generator`'s device (the
    default generator's, the CPU, if None), then moved to `device`."""
    gen_device = generator.device if generator is not None else "cpu"
    p = torch.full((num_edges,), keep_prob, dtype=torch.float32, device=gen_device)
    keep = torch.bernoulli(p, generator=generator)
    return (keep.to(dtype) / keep_prob).to(device)


def dropedge_aggregate(g: DropEdgeGraph, x: torch.Tensor,
                       generator: torch.Generator | None = None, keep_prob: float = 0.8,
                       deterministic: bool = False, *, impl: str = "auto") -> torch.Tensor:
    """Sum-aggregate over a random edge subset drawn per call, scaled by
    1/keep_prob so the expectation is the full graph's. Pass
    deterministic=True (or keep_prob=1.0) at eval time. impl: "auto" (K4,
    or K1 on the eval fast path) or "reference" (their plain versions)."""
    if deterministic or keep_prob >= 1.0:
        if not g.has_duplicate_edges:
            return spmm_ad(g.plan, g.plan_t, x, impl=impl)
        w = torch.ones(g.num_edges, dtype=x.dtype, device=x.device)
    else:
        w = dropedge_weights(g.num_edges, keep_prob, generator, x.dtype, x.device)
    plane = _scatter_plane(g.plan, g.slots, w)
    # the transpose plane is read only by the feature gradient
    plane_t = (_scatter_plane(g.plan_t, g.slots_t, w)
               if x.requires_grad and torch.is_grad_enabled() else None)
    return spmm_weighted_ad(dataclasses.replace(g.plan, values=plane),
                            dataclasses.replace(g.plan_t, values=plane_t), x, impl=impl)

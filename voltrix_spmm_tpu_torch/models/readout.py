"""Graph-level readout and the GIN graph classifier over block-diagonal
batches (counterpart of voltrix_spmm_tpu/models/readout.py).

A batch of small graphs is one block-diagonal adjacency
(`data.block_diagonal`), so each GIN layer is one SpMM for the whole
batch (K1 on a default plan on the card); each graph's node embeddings
are then pooled into one vector. The classifier pools both layers'
embeddings and concatenates them before a linear head (jumping
knowledge, the GIN paper's recipe for graph classification).

The pooling takes graph ids in any order, as JAX's segment_sum and
segment_max do: the nodes are put in graph order by a stable sort
(`models.gat.edge_order`, kept beside the ids tensor) and each graph's
nodes are reduced in that order by `torch.segment_reduce`, with no float
atomics, so the same inputs give the same bits in every run; the
backward is a gather. An empty graph pools to 0 under "sum" and "mean"
and to -inf under "max", as in JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .gat import _RowsSum, edge_order
from .gin import _gin_layer
from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax

PARAM_NAMES = ("eps1", "w1a", "b1a", "w1b", "b1b", "eps2", "w2a", "b2a", "w2b", "b2b",
               "w_head", "b_head")


class _SegmentMax(torch.autograd.Function):
    """Per-graph max over the nodes in graph order; backward, each graph's
    gradient shared equally among the nodes that reach its max (JAX's rule
    for ties), the tie counts summed in the same fixed order."""

    @staticmethod
    def forward(ctx, x, ids, order):
        out = torch.segment_reduce(order.sort(x), "max", offsets=order.offsets, unsafe=True)
        ctx.save_for_backward(x, ids, out)
        ctx.order = order
        return out

    @staticmethod
    def backward(ctx, grad):
        x, ids, out = ctx.saved_tensors
        hit = (x == out.index_select(0, ids)).to(grad.dtype)
        ties = torch.segment_reduce(ctx.order.sort(hit), "sum", offsets=ctx.order.offsets,
                                    unsafe=True)
        share = grad / ties.clamp_min(1.0)
        return hit * share.index_select(0, ids), None, None


def graph_readout(x: torch.Tensor, graph_ids, num_graphs: int, mode: str = "sum") -> torch.Tensor:
    """Pool node features (N, D) into per-graph vectors (num_graphs, D).

    graph_ids: int (N,) graph of each node (`data.node_graph_ids`), numpy
    or a tensor, in any order; pass the same tensor on every call to build
    its order once. mode: "sum", "mean" or "max"."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(f"unknown readout mode {mode!r}")
    if not isinstance(graph_ids, torch.Tensor):
        graph_ids = torch.from_numpy(np.asarray(graph_ids, np.int64))
    ids = graph_ids.to(device=x.device, dtype=torch.int64)
    order = edge_order(ids, num_graphs)
    if mode == "max":
        return _SegmentMax.apply(x, ids, order)
    s = _RowsSum.apply(x, ids, order)
    if mode == "sum":
        return s
    counts = torch.diff(order.offsets).to(x.dtype)[:, None]
    return s / counts.clamp_min(1.0)


def _gin_mlp(*args):
    return torch.relu(_gin_layer(*args))


def gin_classifier_forward(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor,
                           graph_ids, num_graphs: int, readout: str = "sum", *,
                           impl: str = "auto") -> torch.Tensor:
    """Logits (num_graphs, num_classes) of a block-diagonal batch: equal to
    running each graph alone, since the adjacency is block-diagonal and
    GIN sums. impl: "auto" (the plan's kernel) or "reference"."""
    p = params
    h1 = _gin_mlp(x, aggregate(g, x, mode="sum", impl=impl), p["eps1"], p["w1a"], p["b1a"],
                  p["w1b"], p["b1b"])
    h2 = _gin_mlp(h1, aggregate(g, h1, mode="sum", impl=impl), p["eps2"], p["w2a"], p["b2a"],
                  p["w2b"], p["b2b"])
    pooled = torch.cat([graph_readout(h1, graph_ids, num_graphs, readout),
                        graph_readout(h2, graph_ids, num_graphs, readout)], dim=1)
    return pooled @ p["w_head"] + p["b_head"]


def gin_classifier_loss(params: Mapping[str, torch.Tensor], g: GraphData, x: torch.Tensor,
                        graph_ids, num_graphs: int, labels: torch.Tensor, *,
                        impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the graphs' logits (sum readout)."""
    return F.cross_entropy(
        gin_classifier_forward(params, g, x, graph_ids, num_graphs, impl=impl), labels)


def make_classifier_train_step(optimizer: torch.optim.Optimizer):
    """The counterpart of the JAX package's make_classifier_train_step:
    returns `step(params, g, x, graph_ids, labels, *, impl="auto") ->
    loss`, num_graphs taken from labels' length. One step zeroes the
    gradients, runs `gin_classifier_loss` forward and backward and steps
    `optimizer`, which holds the tensors of `params` (as
    `GINClassifier.params()`)."""

    def step(params, g, x, graph_ids, labels, *, impl: str = "auto") -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = gin_classifier_loss(params, g, x, graph_ids, labels.shape[0], labels, impl=impl)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def gin_classifier_params_from_jax(params: Mapping, device="cuda") -> dict:
    """The JAX package's `init_gin_classifier` parameters as float32
    tensors on `device`."""
    return params_from_jax({k: params[k] for k in PARAM_NAMES}, device)


class GINClassifier(ParamTree):
    """Two GIN layers (MLPs to `hidden`) and a linear head over both
    layers' pooled embeddings, initialised as `init_gin_classifier` does
    (He normal weights, the head by sqrt(1 / hidden), zero biases and
    eps), from a torch.Generator."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        s_in, s_h = (2.0 / in_dim) ** 0.5, (2.0 / hidden) ** 0.5

        def zeros(*shape):
            return torch.zeros(*shape, device=device)

        self._set_tree({
            "eps1": zeros(()), "w1a": normal(generator, (in_dim, hidden), s_in, device),
            "b1a": zeros(hidden), "w1b": normal(generator, (hidden, hidden), s_h, device),
            "b1b": zeros(hidden), "eps2": zeros(()),
            "w2a": normal(generator, (hidden, hidden), s_h, device), "b2a": zeros(hidden),
            "w2b": normal(generator, (hidden, hidden), s_h, device), "b2b": zeros(hidden),
            "w_head": normal(generator, (2 * hidden, num_classes), (1.0 / hidden) ** 0.5,
                             device),
            "b_head": zeros(num_classes),
        })

    def forward(self, g: GraphData, x: torch.Tensor, graph_ids, num_graphs: int,
                readout: str = "sum", *, impl: str = "auto") -> torch.Tensor:
        return gin_classifier_forward(self.params(), g, x, graph_ids, num_graphs, readout,
                                      impl=impl)

"""Mini-batch GraphSAGE over neighbour-sampled blocks (counterpart of
voltrix_spmm_tpu/models/sage_minibatch.py).

Layer l reads hop l's block (`data.sampling.sample_blocks`, input side
first): h_dst = act(h[:num_dst] @ W_self + (inv_deg * SpMM(block, h)) @
W_neigh + b), the mean over the sampled edges. Each SpMM is `spmm_ad` on
the block's rectangular plan (K1 on the card; its backward K1 over the
transpose plan). `sage_inference` serves the trained weights with full
neighbourhoods on the whole graph.

What moves to the card: `blocks_args` moves each hop's plan and inverse
degrees, and the transpose plans of the hops whose input needs a
gradient. blocks[0]'s input is the raw features, which need none, so its
transpose plan (the largest array of a batch) stays on the host unless
the caller asks for the features' gradient. The SampleBlocks themselves
stay on the host as sampled. Each new plan's work list is built on the
host at its first launch (`ops.block_spmm.plan_walk`), once per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.autodiff import spmm_ad
from .graph import GraphData, aggregate
from .params import ParamTree, normal, params_from_jax


def blocks_args(blocks, device="cuda", *, input_grad: bool = False):
    """(plans, inv_degs) of `blocks` on `device`: [(plan, plan_t), ...] and
    float32 (num_dst, 1) tensors, the arguments of the step that
    `make_sage_minibatch_step` returns. blocks[0].plan_t is moved only with
    input_grad=True (the gradient of the raw features); otherwise it stays
    where it is and is never read."""
    plans, inv_degs = [], []
    for l, blk in enumerate(blocks):
        plan_t = blk.plan_t.to(device) if l > 0 or input_grad else blk.plan_t
        plans.append((blk.plan.to(device), plan_t))
        inv_degs.append(torch.from_numpy(blk.inv_deg).to(device))
    return plans, inv_degs


def _forward(params, plans, inv_degs, x_src, impl):
    if len(params) != len(plans):
        raise ValueError(f"{len(params)} layers for {len(plans)} sampled blocks")
    h = x_src
    last = len(plans) - 1
    for l, ((plan, plan_t), invd, p) in enumerate(zip(plans, inv_degs, params)):
        # source slot j < num_dst is dst j itself (data.sampling)
        self_h = h[: plan.num_nodes]
        agg = invd * spmm_ad(plan, plan_t, h, impl=impl)
        z = self_h @ p["w_self"] + agg @ p["w_neigh"] + p["b"]
        h = torch.relu(z) if l < last else z
    return h


def sage_minibatch_forward(params, blocks, x_src: torch.Tensor, *,
                           impl: str = "auto") -> torch.Tensor:
    """Logits of the seed rows. blocks: `sample_blocks` output; x_src: the
    features of blocks[0]'s padded source list (`gather_features`), on the
    device the plans are moved to. impl: "auto" (K1) or "reference"."""
    plans, inv_degs = blocks_args(blocks, x_src.device,
                                  input_grad=x_src.requires_grad and torch.is_grad_enabled())
    return _forward(params, plans, inv_degs, x_src, impl)


def sage_minibatch_loss(params, blocks, x_src: torch.Tensor, labels: torch.Tensor, *,
                        impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the seed rows' logits."""
    return F.cross_entropy(sage_minibatch_forward(params, blocks, x_src, impl=impl), labels)


def make_sage_minibatch_step(optimizer: torch.optim.Optimizer):
    """The counterpart of the JAX package's make_sage_minibatch_step:
    returns `step(params, plans, inv_degs, x_src, y, *, impl="auto") ->
    loss`, where plans and inv_degs are `blocks_args(blocks)`. One step
    zeroes the gradients, runs the loss forward and backward and steps
    `optimizer`, which holds the tensors of `params` (as
    `SageMinibatch.params()`); the parameters are updated in place."""

    def step(params, plans, inv_degs, x_src, y, *, impl: str = "auto") -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(_forward(params, plans, inv_degs, x_src, impl), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def sage_inference(params, g: GraphData, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Layer-wise full-graph inference with mini-batch-trained weights:
    each layer aggregates every node's whole neighbourhood (`aggregate`,
    one SpMM a layer on g's plan); logits of every node."""
    h = x
    for l, p in enumerate(params):
        agg = aggregate(g, h, mode="mean", impl=impl)
        z = h @ p["w_self"] + agg @ p["w_neigh"] + p["b"]
        h = torch.relu(z) if l + 1 < len(params) else z
    return h


def sage_minibatch_params_from_jax(params, device="cuda") -> list:
    """The JAX package's `init_sage_minibatch` parameters (a list of
    {"w_self", "w_neigh", "b"}) as float32 tensors on `device`."""
    return params_from_jax([{k: p[k] for k in ("w_self", "w_neigh", "b")} for p in params],
                           device)


class SageMinibatch(ParamTree):
    """One SAGE layer per sampled hop, dims = [in_dim, hidden..., classes],
    initialised as `init_sage_minibatch` does (normal weights scaled by
    sqrt(1 / fan_in), zero biases), from a torch.Generator. `params()` is
    the list of per-layer dicts the functions above take."""

    def __init__(self, dims: list[int], *, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        layers = []
        for a, b in zip(dims[:-1], dims[1:]):
            s = (1.0 / a) ** 0.5
            layers.append({"w_self": normal(generator, (a, b), s, device),
                           "w_neigh": normal(generator, (a, b), s, device),
                           "b": torch.zeros(b, device=device)})
        self._set_tree(layers)

    def forward(self, blocks, x_src: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return sage_minibatch_forward(self.params(), blocks, x_src, impl=impl)

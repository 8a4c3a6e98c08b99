"""Full-graph distributed GCN training on the row-sharded SpMM
(counterpart of voltrix_spmm_tpu/parallel/row_sharded_gcn.py).

Each rank owns a range of node rows (its rows of A, X and the labels);
every layer all-gathers the activations over the axis, aggregates locally
through the rectangular plan (K1 on the card, `spmm_ad` over the shard's
transpose plan backward) and keeps its rows. The all-gather's backward is
a reduce-scatter, so each rank's activation gradient reaches its owner.

`FullGraphStep` is the SGD step that this trainer and the ring, hybrid
and 2D-grid trainers share: the loss is this rank's numerator over the
global count of labelled rows, the count taken outside autograd (an
in-graph sum of the count would differentiate into another sum and scale
every gradient by the axis size, row_sharded_gcn.py:103-111 of the JAX
package), and the parameter gradients are summed over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import spmm_ad
from . import comm
from .row_sharded import RowShardedPlan, check_group, check_rows


def _local_aggregate(plan: RowShardedPlan, shard, x_local: torch.Tensor, group) -> torch.Tensor:
    """Sum aggregation of this rank's rows: all-gather X's rows over the
    group, then `spmm_ad` with the shard's plan and transpose plan
    (`shard`, from `plan.local`). Differentiable end to end."""
    local_plan, local_plan_t = shard
    return spmm_ad(local_plan, local_plan_t, comm.all_gather(x_local, group))


def masked_loss_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The summed softmax cross-entropy of the rows with a label >= 0 (a
    label of -100 marks a padding row)."""
    losses = F.cross_entropy(logits, y.clamp_min(0).long(), reduction="none")
    return torch.where(y >= 0, losses, torch.zeros_like(losses)).sum()


class FullGraphStep:
    """One SGD step of a full-graph GCN whose rows are sharded over
    `group`: `step(params, x, y) -> (params, loss)` on this rank's rows of
    the features and labels (label -100 excludes a row), with `params` a
    dict of replicated tensors (w1, b1, w2, b2) and the global loss; the
    new parameters are p - lr * g. `forward(params, x)` gives this rank's
    logits."""

    def __init__(self, aggregate, inv_deg: torch.Tensor, rows: int, lr: float, group, what: str):
        self._aggregate, self._invd, self._rows = aggregate, inv_deg, rows
        self.lr, self.group, self._what = lr, group, what

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        check_rows(x, self._rows, self._what)
        h = self._invd * self._aggregate(x)
        h = torch.relu(h @ params["w1"] + params["b1"])
        h = self._invd * self._aggregate(h)
        return h @ params["w2"] + params["b2"]

    def __call__(self, params, x: torch.Tensor, y: torch.Tensor):
        check_rows(x, self._rows, self._what)
        # the global count OUTSIDE the differentiated function
        count = comm.psum((y >= 0).sum().to(torch.float32), self.group).clamp_min(1.0)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        # this rank's numerator over the global count: its gradient is
        # exactly this shard's share of the loss's
        local_loss = masked_loss_sum(self.forward(p, x), y) / count
        grads = torch.autograd.grad(local_loss, list(p.values()))
        # the parameters are replicated: sum the shards' shares, and the
        # loss (for the report) with them, in one all-reduce
        flat = comm.psum(torch.cat([g.reshape(-1) for g in grads] + [local_loss.reshape(1)]),
                         self.group)
        new, at = {}, 0
        for (k, v), g in zip(p.items(), grads):
            new[k] = (v - self.lr * flat[at: at + g.numel()].view_as(v)).detach()
            at += g.numel()
        return new, flat[-1]


def local_inv_deg(plan, inv_deg, index: int, device) -> torch.Tensor:
    """Shard `index`'s rows of inv_deg ((num_nodes,) or (num_nodes, 1),
    `plan.rows_of`) as a float32 (rows, 1) tensor on `device`."""
    invd = np.asarray(inv_deg, np.float32).reshape(-1)
    if invd.shape[0] != plan.num_nodes:
        raise ValueError(f"inv_deg has {invd.shape[0]} rows, the plan {plan.num_nodes}")
    return torch.from_numpy(np.array(plan.rows_of(invd, index)).reshape(-1, 1)).to(device)


def make_row_sharded_train_step(plan: RowShardedPlan, mesh, inv_deg, lr: float = 1e-2,
                                axis="data", device=None) -> FullGraphStep:
    """The full-graph GCN training step: parameters replicated, node rows
    (features, labels, outputs) sharded over `axis`, a mesh dimension name
    or a tuple of names (e.g. ("host", "chip") on a 2D mesh shards rows
    over both, numbered row-major).

    inv_deg: (num_nodes,) or (num_nodes, 1) float32, 1/max(degree, 1) of
    the padded rows (0 on padding). The step takes this rank's rows: x =
    plan.rows_of(x_global, index) (D columns) and y likewise (label -100
    on rows excluded from the loss), index = comm.shard_index(mesh, axis).
    This rank's plan, transpose plan and inv_deg rows move to `device`
    (the card, cuda:{local rank % device_count}, unless "cpu") here, once.
    """
    if plan.bitmask_t is None:
        raise ValueError("build_row_sharded_plan(..., with_transpose=True) required for training")
    group = comm.axis_group(mesh, axis)
    index = check_group(plan, group, "make_row_sharded_train_step")
    device = comm.rank_device(device)
    shard = plan.local(index, device)
    # a balanced plan runs in permuted position space: inv_deg follows the
    # permutation (the loss is permutation-invariant: nothing scatters back)
    invd = local_inv_deg(plan, inv_deg, index, device)
    return FullGraphStep(lambda h: _local_aggregate(plan, shard, h, group), invd,
                         plan.shard_rows, lr, group, "make_row_sharded_train_step")

"""Link prediction: a GCN encoder and an SDDMM dot-product edge decoder
(counterpart of voltrix_spmm_tpu/models/linkpred.py).

A two-layer GCN encodes the nodes; the candidate edges (the graph's edges
and sampled non-edges) form an ELL plan, and `link_scores` scores all of
them in one differentiable SDDMM, score(u, v) = h_u . h_v (kernel K7;
backward two K6), trained with per-edge sigmoid cross-entropy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..format.ell import EllPlan, build_ell_pair
from ..format.plan import PlanConfig
from ..ops.ell import sddmm_ell_ad
from .gcn import GCN, gcn_forward
from .graph import GraphData


def sample_negative_edges(indptr, indices, num_nodes: int, num_neg: int,
                          rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """`num_neg` distinct uniform (u, v) pairs that are neither edges of A
    nor self-loops, sorted by (u, v).

    The JAX package draws u, then v, one pair at a time and rejects
    self-loops, edges and repeats. This draws the same stream in rounds of
    as many pairs as are still missing (a round can accept no more than
    that), keeps the pairs the one-at-a-time loop would keep, in order,
    and so returns the same pairs and leaves `rng` in the same state."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if num_neg <= 0:
        z = np.zeros(0, np.int64)
        return z, z
    have = np.unique(np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr)) * num_nodes
                     + indices)
    free = num_nodes * (num_nodes - 1) - int(np.count_nonzero(have // num_nodes != have % num_nodes))
    if num_neg > free:
        raise ValueError(f"{num_neg} negative pairs asked for, {free} exist")
    taken = np.zeros(0, np.int64)  # sorted accepted keys u * n + v
    while taken.shape[0] < num_neg:
        need = num_neg - taken.shape[0]
        uv = rng.integers(0, num_nodes, size=2 * need).reshape(need, 2)
        keys = uv[:, 0] * num_nodes + uv[:, 1]
        ok = uv[:, 0] != uv[:, 1]
        ok &= ~_isin_sorted(keys, have)
        ok &= ~_isin_sorted(keys, taken)
        # a key repeated inside the round is kept at its first draw only
        first = np.zeros(need, bool)
        first[np.unique(keys, return_index=True)[1]] = True
        taken = np.union1d(taken, keys[ok & first])
    return taken // num_nodes, taken % num_nodes


def _isin_sorted(keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    if sorted_keys.shape[0] == 0:
        return np.zeros(keys.shape[0], bool)
    pos = np.minimum(np.searchsorted(sorted_keys, keys), sorted_keys.shape[0] - 1)
    return sorted_keys[pos] == keys


def build_link_candidates(indptr, indices, num_nodes: int, rng: np.random.Generator,
                          neg_ratio: float = 1.0, config: PlanConfig = PlanConfig(128, 128),
                          device="cuda") -> tuple[EllPlan, EllPlan, torch.Tensor]:
    """The candidate edges, every edge of A and round(neg_ratio * nnz)
    sampled non-edges, as (plan, plan_t, labels): an ELL pair on `device`
    (the card unless the caller asks for the CPU) and float32 labels (1 =
    an edge of A) in the plan's CSR edge order."""
    import scipy.sparse as sp

    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    pos_rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    n_neg = int(round(neg_ratio * len(indices)))
    neg_rows, neg_cols = sample_negative_edges(indptr, indices, num_nodes, n_neg, rng)
    rows = np.concatenate([pos_rows, neg_rows])
    cols = np.concatenate([indices, neg_cols])
    # the label rides the COO -> CSR reorder as value 2 (edge) or 1
    # (non-edge): scipy drops explicit zeros, and the two sets are disjoint
    tag = np.concatenate([np.full(len(indices), 2.0, np.float32),
                          np.full(len(neg_cols), 1.0, np.float32)])
    cand = sp.csr_matrix((tag, (rows, cols)), shape=(num_nodes, num_nodes))
    labels = (cand.data - 1.0).astype(np.float32)
    plan, plan_t = build_ell_pair(cand.indptr.astype(np.int64), cand.indices.astype(np.int64),
                                  num_nodes, config=config)
    return plan.to(device), plan_t.to(device), torch.from_numpy(labels).to(device)


def link_scores(plan: EllPlan, plan_t: EllPlan, h: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """Per-candidate-edge scores h_u . h_v in the plan's CSR edge order,
    differentiable in the embeddings h (`sddmm_ell_ad`)."""
    h32 = h.float().contiguous()
    return sddmm_ell_ad(plan, plan_t, h32, h32, impl=impl)


def init_link_predictor(in_dim: int, hidden: int, emb_dim: int, *,
                        generator: torch.Generator | None = None, device="cuda") -> GCN:
    """The encoder: a two-layer GCN emitting emb_dim node embeddings."""
    return GCN(in_dim, hidden, emb_dim, generator=generator, device=device)


def link_pred_loss(params, g: GraphData, plan: EllPlan, plan_t: EllPlan, x: torch.Tensor,
                   labels: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Mean sigmoid cross-entropy of the candidate scores against the labels."""
    scores = link_scores(plan, plan_t, gcn_forward(params, g, x, impl=impl), impl=impl)
    return F.binary_cross_entropy_with_logits(scores, labels)


def make_link_pred_step(optimizer: torch.optim.Optimizer):
    """The counterpart of the JAX package's make_link_pred_step: returns
    `step(params, g, plan, plan_t, x, labels, *, impl="auto") -> loss`,
    one step that zeroes the gradients, runs `link_pred_loss` forward and
    backward and steps `optimizer`, which holds the tensors of `params`
    (as `GCN.params()`); the parameters are updated in place."""

    def step(params, g, plan, plan_t, x, labels, *, impl: str = "auto") -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = link_pred_loss(params, g, plan, plan_t, x, labels, impl=impl)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def link_auc(scores, labels) -> float:
    """ROC-AUC by the Mann-Whitney rank statistic with tie-averaged ranks,
    in numpy (tensors are brought to the host)."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.detach().cpu().numpy()
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    _, inv, counts = np.unique(scores, return_inverse=True, return_counts=True)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    avg_rank = start + (counts + 1) / 2.0  # 1-based average rank per tie group
    ranks = avg_rank[inv]
    n_pos = float(labels.sum())
    n_neg = float(len(labels) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))

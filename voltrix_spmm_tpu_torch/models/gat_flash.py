"""Flash GAT: dot-product attention GAT on the fused multi-head op
(counterpart of voltrix_spmm_tpu/models/gat_flash.py).

The same model as models/gat_ell.py (scores leaky_relu(scale q_u . k_v,
0.2), a softmax over each node's in-neighbours, aggregate v), but each
layer is one `spmm_attention_mh_ad` over all its heads: kernel K13
forward, K14 and K15 backward, over the binary plans of A and A^T. No
O(nnz) tensor exists; the residuals are out and lse, O(n).

The graph is a `GraphData` (models/graph.py) or a (plan, plan_t[,
plane_dtype]) tuple. The plane dtype follows the JAX package's rule
(gat_flash.py:101-113): bf16 planes when x has at least 65,536 rows,
unless the tuple names a dtype. A bare `SpmmPlan` takes the JAX package's
per-head single-head path (kernels K9 and K10), which is not ported.

Parameters are those of `GATDot`, as in JAX (`init_gat_flash` is
`init_gat_dot`).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..format.plan import SpmmPlan
from ..ops.attention_mh import spmm_attention_mh_ad
from .gat_ell import GATDot, gat_dot_params_from_jax

BF16_PLANE_ROWS = 65536  # the JAX package's size rule for bf16 planes

_SINGLE_HEAD = ("the single-head flash path (kernels K9 and K10, ops/attention.py) is not "
                "ported: ROADMAP.md item 13")


def flash_attention_aggregate(plan, q, k, v, *, plan_t=None, negative_slope: float = 0.2,
                              scale: float | None = None):
    """One fused attention head (the JAX package's spmm_attention_ad):
    not ported yet."""
    raise NotImplementedError(_SINGLE_HEAD)


def _plan_pair(g):
    """(plan, plan_t, plane_dtype) from a GraphData or a (plan, plan_t[,
    plane_dtype]) tuple; plane_dtype None leaves the choice to the size
    rule."""
    if isinstance(g, SpmmPlan):
        raise NotImplementedError(
            f"a bare SpmmPlan runs the heads one by one in the JAX package; {_SINGLE_HEAD}. "
            "Pass (plan, plan_t) or a GraphData for the multi-head path"
        )
    if isinstance(g, (tuple, list)):
        if len(g) == 3:
            return g[0], g[1], g[2]
        plan, plan_t = g
        return plan, plan_t, None
    return g.plan, g.plan_t, getattr(g, "plane_dtype", None)


def _plane_dtype(override, num_rows: int):
    if override is None:
        return torch.bfloat16 if num_rows >= BF16_PLANE_ROWS else None
    return None if override == torch.float32 else override


def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("nd,hdk->hnk", x, w) as one (n, d) @ (d, H * k) product, whose
    backward is one product too (a batched matmul broadcasting x over the
    heads reduces its weight gradient over n in a slow batched kernel)."""
    heads, d, k = w.shape
    return (x @ w.permute(1, 0, 2).reshape(d, heads * k)).view(-1, heads, k).permute(1, 0, 2)


def gat_flash_forward(params: Mapping[str, torch.Tensor], g, x: torch.Tensor, *,
                      impl: str = "auto") -> torch.Tensor:
    """logits = head2(elu(concat_h head1_h(x))): layer 1 is one
    `spmm_attention_mh_ad` over all heads, the heads concatenated in head
    order; layer 2 the same op with one head; slope 0.2 throughout. impl:
    "auto" runs K13-K15 on the card, "reference" their plain versions."""
    plan, plan_t, override = _plan_pair(g)
    pdt = _plane_dtype(override, x.shape[0])
    q, k, v = (_project_heads(x, params[name]) for name in ("wq1", "wk1", "wv1"))  # (H, n, d)
    heads = spmm_attention_mh_ad(plan, q, k, v, plan_t=plan_t, negative_slope=0.2,
                                 plane_dtype=pdt, impl=impl)
    h = F.elu(heads.permute(1, 0, 2).reshape(x.shape[0], -1))
    out = spmm_attention_mh_ad(plan, (h @ params["wq2"])[None], (h @ params["wk2"])[None],
                               (h @ params["wv2"])[None], plan_t=plan_t, negative_slope=0.2,
                               plane_dtype=pdt, impl=impl)
    return out[0]


def gat_flash_loss(params: Mapping[str, torch.Tensor], g, x: torch.Tensor,
                   labels: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of the logits (the JAX package's
    gat_flash_loss); takes `make_train_step` as its loss."""
    return F.cross_entropy(gat_flash_forward(params, g, x, impl=impl), labels)


def make_gat_flash_train_step(lr: float = 1e-2):
    """The JAX package's SGD step: returns `step(params, g, x, labels, *,
    impl="auto") -> (params, loss)`, the new parameters p - lr * grad as a
    new dict (the inputs are left as they were)."""

    def step(params, g, x, labels, *, impl: str = "auto"):
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        loss = gat_flash_loss(leaves, g, x, labels, impl=impl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = {name: p - lr * gp for (name, p), gp in zip(leaves.items(), grads)}
        return new, loss.detach()

    return step


gat_flash_params_from_jax = gat_dot_params_from_jax


class GATFlash(GATDot):
    """Two-layer flash GAT: GATDot's parameters and initialisation, the
    forward of `gat_flash_forward`."""

    def forward(self, g, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        return gat_flash_forward(self.params(), g, x, impl=impl)

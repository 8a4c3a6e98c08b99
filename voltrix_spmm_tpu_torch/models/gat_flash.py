"""Flash GAT: dot-product attention GAT on the fused attention ops
(counterpart of voltrix_spmm_tpu/models/gat_flash.py).

The same model as models/gat_ell.py (scores leaky_relu(scale q_u . k_v,
0.2), a softmax over each node's in-neighbours, aggregate v), but each
head is one fused op over the binary plan. No O(nnz) tensor exists; the
residuals are out and lse, O(n).

The graph is a `GraphData` (models/graph.py), a (plan, plan_t[,
plane_dtype]) tuple or a bare `SpmmPlan`, and the path follows the JAX
package's (gat_flash.py:96-151):

- with a transpose plan, each layer is one `spmm_attention_mh_ad` over
  all its heads (kernels K13 forward, K14 and K15 backward), with bf16
  planes when x has at least 65,536 rows, unless the tuple names a dtype;
- with plan_t None (a bare plan, or a tuple whose plan_t is None), each
  head is one `flash_attention_aggregate` (`spmm_attention_ad`: K9
  forward, K10 and a scatter of its lane planes by hind backward), in
  float32: the JAX package applies neither the size rule nor a tuple's
  plane dtype there.

Parameters are those of `GATDot`, as in JAX (`init_gat_flash` is
`init_gat_dot`).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..format.plan import SpmmPlan
from ..ops.attention import spmm_attention_ad
from ..ops.attention_mh import spmm_attention_mh_ad
from .gat_ell import GATDot, gat_dot_params_from_jax

BF16_PLANE_ROWS = 65536  # the JAX package's size rule for bf16 planes


def flash_attention_aggregate(plan: SpmmPlan, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, plan_t: SpmmPlan | None = None,
                              negative_slope: float = 0.2, scale: float | None = None,
                              impl: str = "auto") -> torch.Tensor:
    """One attention head, fused: out_u = sum_v alpha_uv v_v with alpha =
    softmax_v(leaky_relu(scale q_u . k_v)) over u's in-neighbours
    (`spmm_attention_ad`). Differentiable in q, k and v; with the
    transpose plan the backward is the split one (K11 and K12), without
    it K10 and a scatter of its lane planes."""
    return spmm_attention_ad(plan, q, k, v, plan_t=plan_t, scale=scale,
                             negative_slope=negative_slope, impl=impl)


def _plan_pair(g):
    """(plan, plan_t, plane_dtype) from a GraphData, a (plan, plan_t[,
    plane_dtype]) tuple, or a bare plan (plan_t None: the per-head path);
    plane_dtype None leaves the choice to the size rule."""
    if isinstance(g, SpmmPlan):
        return g, None, None
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
    """logits = head2(elu(concat_h head1_h(x))), the heads concatenated in
    head order, slope 0.2 throughout. With a transpose plan, layer 1 is one
    `spmm_attention_mh_ad` over all heads and layer 2 the same op with one
    head; with plan_t None, each head is one `flash_attention_aggregate`
    in float32. impl: "auto" runs the kernels on the card, "reference"
    their plain versions."""
    plan, plan_t, override = _plan_pair(g)
    if plan_t is None:
        heads = [flash_attention_aggregate(plan, x @ params["wq1"][h], x @ params["wk1"][h],
                                           x @ params["wv1"][h], impl=impl)
                 for h in range(params["wq1"].shape[0])]
        h = F.elu(torch.cat(heads, dim=1))
        return flash_attention_aggregate(plan, h @ params["wq2"], h @ params["wk2"],
                                         h @ params["wv2"], impl=impl)
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

"""Repeats a step-0 check of chip_smoke.py on the ogbn-arxiv proxy with
self-loops and counts what moves it from run to run: path H (per-head
flash GAT, K9 and K10, on PlanConfig(128, 128, block_unroll=4)), path G
(flash GAT over all heads, K13, K14 and K15, on the same plan, float32
planes as G's check takes them), path E (dot-product GAT, K6 and K7, on
ELL plans of the same geometry) or path D (GAT, K4 and K5, on
PlanConfig(64, 128)). Widths 128 -> 8 heads x 8 -> 40,
parameters drawn as chip_smoke.py draws them, features and labels from
seeds of their own, so the edges near the kink are not the path's own.

    python3 -m voltrix_spmm_tpu_torch.tools.kink_flips [--path H|G|E|D] [--repeats 50]

Needs one CUDA device. leaky_relu's slope jumps from 0.2 to 1 at a score
of 0, so an edge whose layer-2 score lies within rounding of 0 on one path
and across it on the other changes the gradients by about one row's share
(~2e-3 x max|grad| on H, far past its check's 1e-4; G's is 1e-4 too, E's
1e-5, D's 5e-5). The plain path is taken once in torch's deterministic mode. For each
repeat the tool takes the kernel path's layer-2 inputs (the first layer's
heads through the kernels, ELU, the products: q and k, or D's node logits
s and t) and its step-0 gradients, and counts repeats whose layer-2 inputs
differ in any bit from the first repeat's, whose gradients do, whose
scores differ in sign from the plain path's on some edge (float64), and
whose gradients fail the path's check (calc_diff < 1e-6 and
allclose(rtol 1e-4, atol x max|grad|)).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .. import (GAT, GATDot, GATFlash, PlanConfig, build_ell_graph, build_gat_graph, calc_diff,
                csr_preprocess, gat_dot_loss, gat_dot_params_from_jax, gat_flash_loss,
                gat_flash_params_from_jax, gat_loss, gat_params_from_jax)
from ..data import proxy_csr, symmetrize
from ..models.gat import gat_attention_aggregate
from ..models.gat_ell import dot_attention_aggregate
from ..models.gat_flash import _project_heads
from ..ops import (spmm_attention, spmm_attention_mh, spmm_attention_mh_reference,
                   spmm_attention_reference)

CFG = PlanConfig(128, 128, block_unroll=4)
ATOL = {"H": 1e-4, "G": 1e-4, "E": 1e-5, "D": 5e-5}  # chip_smoke.py's step-0 limits, x max|grad|


def path_h(a, params_np, heads, dev):
    """(layer-2 q and k of an impl, step-0 gradients of an impl) on path H."""
    n = a.shape[0]
    plan = csr_preprocess(a.indptr, a.indices, n, CFG).to(dev)
    p = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).params()
    attend = {"auto": spmm_attention, "reference": spmm_attention_reference}

    def layer2_qk(x, impl):
        h = F.elu(torch.cat([attend[impl](plan, x @ p["wq1"][i], x @ p["wk1"][i],
                                          x @ p["wv1"][i], negative_slope=0.2)
                             for i in range(heads)], dim=1))
        return h @ p["wq2"], h @ p["wk2"]

    def grads(x, y, impl):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        loss = gat_flash_loss(leaves, plan, x, y, impl=impl)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    return layer2_qk, grads


def path_g(a, params_np, heads, dev):
    """(layer-2 q and k of an impl, step-0 gradients of an impl) on path G
    with float32 planes (G's step-0 check): the symmetric graph's plan is
    its own transpose."""
    n = a.shape[0]
    plan = csr_preprocess(a.indptr, a.indices, n, CFG).to(dev)
    g32 = (plan, plan, torch.float32)
    p = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).params()
    attend = {"auto": spmm_attention_mh, "reference": spmm_attention_mh_reference}

    def layer2_qk(x, impl):
        q, k, v = (_project_heads(x, p[w]) for w in ("wq1", "wk1", "wv1"))
        out = attend[impl](plan, q, k, v, negative_slope=0.2, plane_dtype=torch.float32)
        h = F.elu(out.permute(1, 0, 2).reshape(n, -1))
        return h @ p["wq2"], h @ p["wk2"]

    def grads(x, y, impl):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        loss = gat_flash_loss(leaves, g32, x, y, impl=impl)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    return layer2_qk, grads


def path_e(a, params_np, heads, dev):
    """(layer-2 q and k of an impl, step-0 gradients of an impl) on path E."""
    g = build_ell_graph(a.indptr, a.indices, a.shape[0], CFG, device=dev)
    p = GATDot.from_params(gat_dot_params_from_jax(params_np, dev)).params()

    def layer2_qk(x, impl):
        h = F.elu(torch.cat([dot_attention_aggregate(g, x @ p["wq1"][i], x @ p["wk1"][i],
                                                     x @ p["wv1"][i], impl=impl)
                             for i in range(heads)], dim=1))
        return h @ p["wq2"], h @ p["wk2"]

    def grads(x, y, impl):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        loss = gat_dot_loss(leaves, g, x, y, impl=impl)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    return layer2_qk, grads


def path_d(a, params_np, heads, dev):
    """(layer-2 node logits s and t of an impl, step-0 gradients of an impl)
    on path D."""
    g = build_gat_graph(a.indptr, a.indices, a.shape[0], PlanConfig(64, 128), device=dev)
    p = GAT.from_params(gat_params_from_jax(params_np, dev)).params()

    def layer2_st(x, impl):
        h = F.elu(torch.cat([gat_attention_aggregate(g, x @ p["w1"][i], p["a1_src"][i],
                                                     p["a1_dst"][i], impl=impl)
                             for i in range(heads)], dim=1)) @ p["w2"]
        return h @ p["a2_src"], h @ p["a2_dst"]

    def grads(x, y, impl):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        loss = gat_loss(leaves, g, x, y, impl=impl)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    return layer2_st, grads


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=("H", "G", "E", "D"), default="H")
    parser.add_argument("--repeats", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kink_flips needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    a = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    a.sort_indices()
    n, (in_dim, hidden, classes), heads = a.shape[0], (128, 8, 40), 8
    prng = np.random.default_rng(2)  # chip_smoke.py's path D, E, G and H parameters
    if args.path == "D":
        params_np = {
            "w1": prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
            "a1_src": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
            "a1_dst": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
            "w2": prng.standard_normal((heads * hidden, classes))
            * (2.0 / (heads * hidden)) ** 0.5,
            "a2_src": prng.standard_normal(classes) * classes ** -0.5,
            "a2_dst": prng.standard_normal(classes) * classes ** -0.5,
        }
    else:
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((heads * hidden, classes))
                          * (2.0 / (heads * hidden)) ** 0.5 for k in ("wq2", "wk2", "wv2")})
    path = {"H": path_h, "G": path_g, "E": path_e, "D": path_d}[args.path]
    layer2, grads = path(a, params_np, heads, dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, in_dim)).astype(np.float32))
    x = x.to(dev)
    y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.from_numpy(np.diff(a.indptr)).to(dev))
    cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)

    def scores(u, v):
        """Layer-2 scores: q_u . k_v (H, E), or s_u + t_v (D), in float64."""
        if args.path == "D":
            return u.double()[rows] + v.double()[cols]
        return (u.double()[rows] * v.double()[cols]).sum(-1)

    torch.use_deterministic_algorithms(True, warn_only=True)
    with torch.no_grad():
        plain_scores = scores(*layer2(x, "reference"))
    want = grads(x, y, "reference")
    torch.use_deterministic_algorithms(False)
    print(f"path {args.path}: {rows.numel()} edges; plain layer-2 scores within 1e-6 / 1e-5 / "
          "1e-4 of the kink: "
          + " / ".join(str(int((plain_scores.abs() < t).sum())) for t in (1e-6, 1e-5, 1e-4)))
    with torch.no_grad():
        first = layer2(x, "auto")
    first_grads = None
    counts = {"inputs_differ": 0, "grads_differ": 0, "sign_flips": 0, "check_fails": 0}
    worst = 0.0
    for i in range(args.repeats):
        with torch.no_grad():
            q, k = layer2(x, "auto")
        flips = int(((scores(q, k) > 0) != (plain_scores > 0)).sum())
        got = grads(x, y, "auto")
        if first_grads is None:
            first_grads = got
        grads_differ = not all(torch.equal(got[name], first_grads[name]) for name in got)
        fails = []
        for name, w in want.items():
            scale = w.abs().max().item()
            worst = max(worst, (got[name] - w).abs().max().item() / max(scale, 1e-30))
            if not (calc_diff(got[name], w) < 1e-6 and torch.allclose(
                    got[name], w, rtol=1e-4, atol=ATOL[args.path] * scale)):
                fails.append(name)
        differ = not (torch.equal(q, first[0]) and torch.equal(k, first[1]))
        counts["inputs_differ"] += differ
        counts["grads_differ"] += grads_differ
        counts["sign_flips"] += flips > 0
        counts["check_fails"] += bool(fails)
        if differ or grads_differ or flips or fails:
            print(f"repeat {i}: layer-2 inputs differ from the first repeat's: {differ}; "
                  f"gradients do: {grads_differ}; edges with a flipped sign {flips}; "
                  f"gradients failing the check {fails}")
    print(f"path {args.path}, {args.repeats} repeats: "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; worst max|diff| / max|grad| {worst:.3e} (limit {ATOL[args.path]:.0e})")


if __name__ == "__main__":
    main()

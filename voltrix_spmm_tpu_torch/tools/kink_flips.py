"""Repeats chip_smoke.py's path H step-0 check (per-head flash GAT on the
ogbn-arxiv proxy with self-loops, PlanConfig(128, 128, block_unroll=4),
widths 128 -> 8 heads x 8 -> 40, parameters drawn as chip_smoke.py draws
them, features and labels from seeds of their own, so the edges near the
kink are not path H's) and counts what moves it from run to run.

    python3 -m voltrix_spmm_tpu_torch.tools.kink_flips [--repeats 50]

Needs one CUDA device. leaky_relu's slope jumps from 0.2 to 1 at a score
of 0, so an edge whose layer-2 score lies within rounding of 0 on one path
and across it on the other changes the gradients by about one row's share
(~2e-3 x max|grad| here, far past the check's 1e-4). The plain path is
taken once in torch's deterministic mode. For each repeat the tool takes
the kernel path's layer-2 q and k (K9 per head, ELU, the products) and its
step-0 gradients, and counts repeats whose q or k differ in any bit from
the first repeat's, whose scores differ in sign from the plain path's on
some edge (float64 dot products), and whose gradients fail the check.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .. import GATFlash, PlanConfig, calc_diff, csr_preprocess, gat_flash_loss
from .. import gat_flash_params_from_jax
from ..data import proxy_csr, symmetrize
from ..ops import spmm_attention, spmm_attention_reference


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=50)
    repeats = parser.parse_args().repeats
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
    plan = csr_preprocess(a.indptr, a.indices, n, PlanConfig(128, 128, block_unroll=4)).to(dev)
    prng = np.random.default_rng(2)  # chip_smoke.py's path H parameters
    params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                 for k in ("wq1", "wk1", "wv1")}
    params_np.update({k: prng.standard_normal((heads * hidden, classes))
                      * (2.0 / (heads * hidden)) ** 0.5 for k in ("wq2", "wk2", "wv2")})
    p = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).params()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, in_dim)).astype(np.float32))
    x = x.to(dev)
    y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.from_numpy(np.diff(a.indptr)).to(dev))
    cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)

    def layer2_qk(attend):
        with torch.no_grad():
            h = F.elu(torch.cat([attend(plan, x @ p["wq1"][i], x @ p["wk1"][i], x @ p["wv1"][i],
                                        negative_slope=0.2) for i in range(heads)], dim=1))
            return h @ p["wq2"], h @ p["wk2"]

    def scores(q, k):
        return (q.double()[rows] * k.double()[cols]).sum(-1)

    def grads(impl):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        loss = gat_flash_loss(leaves, plan, x, y, impl=impl)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    torch.use_deterministic_algorithms(True, warn_only=True)
    plain_scores = scores(*layer2_qk(spmm_attention_reference))
    want = grads("reference")
    torch.use_deterministic_algorithms(False)
    print(f"{rows.numel()} edges; plain layer-2 scores within 1e-6 / 1e-5 / 1e-4 of the kink: "
          + " / ".join(str(int((plain_scores.abs() < t).sum())) for t in (1e-6, 1e-5, 1e-4)))
    first = layer2_qk(spmm_attention)
    counts = {"qk_differ": 0, "sign_flips": 0, "check_fails": 0}
    for i in range(repeats):
        q, k = layer2_qk(spmm_attention)
        flips = int(((scores(q, k) > 0) != (plain_scores > 0)).sum())
        got = grads("auto")
        fails = [name for name, w in want.items()
                 if not (calc_diff(got[name], w) < 1e-6 and torch.allclose(
                     got[name], w, rtol=1e-4, atol=1e-4 * w.abs().max().item()))]
        differ = not (torch.equal(q, first[0]) and torch.equal(k, first[1]))
        counts["qk_differ"] += differ
        counts["sign_flips"] += flips > 0
        counts["check_fails"] += bool(fails)
        if differ or flips or fails:
            print(f"repeat {i}: layer-2 q, k differ from the first repeat's: {differ}; edges "
                  f"with a flipped sign {flips}; gradients failing the check {fails}")
    print(f"{repeats} repeats: " + ", ".join(f"{k} {v}" for k, v in counts.items()))


if __name__ == "__main__":
    main()

"""The spread of the GAT's step-0 gradients from run to run, at the shapes
of chip_smoke.py's path D: the ogbn-arxiv proxy with self-loops,
PlanConfig(64, 128), widths 128 -> 8 heads x 8 -> 40, parameters drawn as
chip_smoke.py draws them, features and labels from seeds.

    python3 -m voltrix_spmm_tpu_torch.tools.grad_spread [--repeats 16]

Needs one CUDA device. The kernel path sums every edge term in a fixed
order (K4 and K5 merge pieces in order, the softmax and the logits'
gathers sum each node's edges with segment sums), so it gives the same
bits in every run; the plain path's K4 adds each block's product into its
window with `index_add_` (float atomics), so its rounding changes from
run to run. The gradient of a1_src sums terms that cancel (a softmax is
blind to a shift of a row's logits), so its error is set by the terms,
not by the small sum. For each repeat the tool prints, per gradient, the
atol (as a multiple of max|grad|) at which chip_smoke.py's check,
allclose(rtol=1e-4), would just pass: kernel path against the plain
path, the plain path against itself, and the kernel path against its
first repeat (0 where it repeats bit for bit).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import PlanConfig
from ..data import proxy_csr, symmetrize
from ..models import GAT, build_gat_graph, gat_loss, gat_params_from_jax


def needed_atol(got: torch.Tensor, want: torch.Tensor, rtol: float = 1e-4) -> float:
    """The least atol / max|want| at which allclose(got, want, rtol, atol)
    holds."""
    excess = ((got - want).abs() - rtol * want.abs()).max().item()
    return max(excess, 0.0) / max(want.abs().max().item(), 1e-30)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=16)
    repeats = parser.parse_args().repeats
    if not torch.cuda.is_available():
        raise SystemExit("grad_spread needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    loops = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    loops.sort_indices()
    n, (in_dim, hidden, classes), heads = loops.shape[0], (128, 8, 40), 8
    g = build_gat_graph(loops.indptr, loops.indices, n, PlanConfig(64, 128), device=dev)
    prng = np.random.default_rng(2)  # chip_smoke.py's path D parameters
    params_np = {
        "w1": prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
        "a1_src": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
        "a1_dst": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
        "w2": prng.standard_normal((heads * hidden, classes)) * (2.0 / (heads * hidden)) ** 0.5,
        "a2_src": prng.standard_normal(classes) * classes ** -0.5,
        "a2_dst": prng.standard_normal(classes) * classes ** -0.5,
    }
    params = GAT.from_params(gat_params_from_jax(params_np, dev)).params()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, in_dim)).astype(np.float32))
    x = x.to(dev)
    y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)

    def grads(impl):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss = gat_loss(leaves, g, x, y, impl=impl)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    worst = {"kernel vs plain": 0.0, "plain vs plain": 0.0, "kernel vs kernel": 0.0}
    first = None
    for i in range(repeats):
        kern, plain, plain2 = grads("auto"), grads("reference"), grads("reference")
        first = kern if first is None else first
        for label, a, b in (("kernel vs plain", kern, plain), ("plain vs plain", plain2, plain),
                            ("kernel vs kernel", kern, first)):
            need = {k: needed_atol(a[k], b[k]) for k in b}
            top = max(need, key=need.get)
            worst[label] = max(worst[label], need[top])
            print(f"repeat {i} {label}: atol / max|grad| needed "
                  f"{', '.join(f'{k} {v:.3e}' for k, v in need.items())}; largest {top}")
    print(f"largest over {repeats} repeats: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


if __name__ == "__main__":
    main()

"""Kernel K7's two kernels against the width rule and the wide kernel's
piece limit (ops/ell.py: DVALS_WIDE_MIN_D, the narrowest rows the wide
kernel takes, and DVALS_PIECE_LANES, the most lanes of one window a thread
block of it walks), at the shapes of chip_smoke.py's paths E (the
ogbn-arxiv proxy with self-loops, ELL PlanConfig(128, 128, block_unroll=4),
d 8 and 40 on the path, 128 and 256 beside them) and F (the ogbl-ddi
proxy's link candidates, PlanConfig(128, 128), d 256 on the path, 64 and
128 beside it).

    python3 -m voltrix_spmm_tpu_torch.tools.k7_sweep

Needs one CUDA device. Each (path, width, kernel, limit) is timed twice
with CUDA events (mean of 20 launches after 3 warm-up), the settings in
turns: up, then down. torch.sparse.sampled_addmm on the pattern is timed
once per (path, width) as the yardstick. Features are random, made from a
seed.
"""

from __future__ import annotations

import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import PlanConfig, build_ell_graph, build_link_candidates
from ..data import proxy_csr, symmetrize
from ..ops import ell, spmm_ell_dvals
from .k6_piece_sweep import cuda_ms

PIECES = (1024, 2048, 4096, 8192, 16384)
WIDTHS = {"E": (8, 40, 128, 256), "F": (64, 128, 256)}


def pattern_csr(plan, dev):
    """The plan's real lanes as a binary CSR (rows: destination, cols: source)."""
    K, H = plan.config.block_w, plan.config.block_h
    e = plan.erow.reshape(-1).long()
    rows = plan.window_of_block.long().repeat_interleave(K) * H + e
    keep = (e >= 0) & (rows < plan.num_nodes)
    cols = plan.hind.reshape(-1).long()[keep]
    a = sp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                       (rows[keep].cpu().numpy(), cols.cpu().numpy())),
                      shape=(plan.num_nodes, plan.source_rows))
    a.sum_duplicates()
    return torch.sparse_csr_tensor(torch.from_numpy(a.indptr).long(),
                                   torch.from_numpy(a.indices).long(),
                                   torch.ones(a.nnz), size=a.shape).to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k7_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    loops = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    plan_e = build_ell_graph(loops.indptr, loops.indices, loops.shape[0],
                             PlanConfig(128, 128, block_unroll=4), device=dev).plan
    ddi = symmetrize(proxy_csr("ddi", seed=0))
    plan_f, _, _ = build_link_candidates(ddi.indptr, ddi.indices, ddi.shape[0],
                                         np.random.default_rng(5), device=dev)
    cases = []
    for name, plan in (("E", plan_e), ("F", plan_f)):
        csr = pattern_csr(plan, dev)
        for d in WIDTHS[name]:
            feat = torch.randn(plan.source_rows, d, device=dev, generator=gen)
            g = torch.randn(plan.num_nodes, d, device=dev, generator=gen)
            feat_t = feat.t().contiguous()
            lib = cuda_ms(lambda: torch.sparse.sampled_addmm(csr, g, feat_t, beta=0.0))
            print(f"path {name} d{d}: torch.sparse.sampled_addmm {lib:.4f} ms")
            cases.append((name, d, plan, feat, g))
        del csr
    # (kernel, piece limit): the sub-group kernel, then the wide one at each limit
    settings = [("narrow", None)] + [("wide", p) for p in PIECES]
    defaults = ell.DVALS_WIDE_MIN_D, ell.DVALS_PIECE_LANES
    times: dict = {}
    try:
        for order in (settings, settings[::-1]):
            for kernel, limit in order:
                ell.DVALS_WIDE_MIN_D = 10**9 if kernel == "narrow" else 1
                ell.DVALS_PIECE_LANES = limit or defaults[1]
                for name, d, plan, feat, g in cases:
                    if kernel == "wide" and not ell._k7_wide(d, plan.config.block_h, True):
                        continue
                    ms = cuda_ms(lambda: spmm_ell_dvals(plan, feat, g))
                    times.setdefault((name, d, kernel, limit or 0), []).append(ms)
                torch.cuda.empty_cache()
    finally:
        ell.DVALS_WIDE_MIN_D, ell.DVALS_PIECE_LANES = defaults
    for (name, d, kernel, limit), t in sorted(times.items()):
        what = "sub-group kernel" if kernel == "narrow" else f"wide kernel, DVALS_PIECE_LANES {limit}"
        print(f"K7 path {name} d{d} {what}: {t[0]:.4f} / {t[1]:.4f} ms")


if __name__ == "__main__":
    main()

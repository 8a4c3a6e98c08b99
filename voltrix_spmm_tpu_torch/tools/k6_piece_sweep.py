"""Kernel K6's time against its piece limit (PIECE_LANES, the most lanes of
one row a warp sums) at the shapes of chip_smoke.py's paths E (the
ogbn-arxiv proxy with self-loops, PlanConfig(128, 128, block_unroll=4),
d = 8 and 40) and F (the ogbl-ddi proxy's link candidates,
PlanConfig(128, 128), d = 256).

    python3 -m voltrix_spmm_tpu_torch.tools.k6_piece_sweep

Needs one CUDA device. Each (path, width, limit) is timed twice with CUDA
events (mean of 20 launches after 3 warm-up), the limits in turns: up,
then down. Beside each: the row order's pieces, its cut rows and the
workspace.
"""

from __future__ import annotations

import dataclasses
import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import PlanConfig, build_ell_graph, build_link_candidates, lane_values
from ..data import proxy_csr, symmetrize
from ..ops import ell, spmm_ell
from ..ops.ell import plan_rows

LIMITS = (16, 32, 64, 128, 256, 512, 1024)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k6_piece_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    loops = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    g = build_ell_graph(loops.indptr, loops.indices, loops.shape[0],
                        PlanConfig(128, 128, block_unroll=4), device=dev)
    plan_e = dataclasses.replace(
        g.plan, vals=lane_values(g.plan, torch.rand(loops.nnz, device=dev) / 20))
    ddi = symmetrize(proxy_csr("ddi", seed=0))
    cand, _, _ = build_link_candidates(ddi.indptr, ddi.indices, ddi.shape[0],
                                       np.random.default_rng(5), device=dev)
    plan_f = dataclasses.replace(cand, vals=lane_values(cand, torch.randn(cand.num_edges,
                                                                          device=dev)))
    cases = [("E", plan_e, 8), ("E", plan_e, 40), ("F", plan_f, 256)]
    feats = {d: torch.randn(p.source_rows, d, device=dev) for _, p, d in cases}
    times: dict = {}
    default = ell.PIECE_LANES
    try:
        for order in (LIMITS, LIMITS[::-1]):
            for limit in order:
                ell.PIECE_LANES = limit
                for name, p, d in cases:
                    ms = cuda_ms(lambda: spmm_ell(p, feats[d]))
                    rows = plan_rows(p)
                    entry = times.setdefault((name, d, limit), {"ms": [], "rows": rows})
                    entry["ms"].append(ms)
    finally:
        ell.PIECE_LANES = default
    for (name, d, limit), t in sorted(times.items()):
        rows = t["rows"]
        print(f"K6 path {name} d{d} PIECE_LANES {limit}: {t['ms'][0]:.4f} / {t['ms'][1]:.4f} ms; "
              f"{rows.items.shape[0]} pieces, {rows.merges.shape[0]} rows cut, workspace "
              f"{rows.slots * d * 4 / 2**20:.2f} MiB")


if __name__ == "__main__":
    main()

"""Kernels K1 and K2 against their piece limits (PIECE_BLOCKS, the most
blocks of one window a thread block walks, and PIECE_WORK, about the most
work), at the shapes of chip_smoke.py's paths A (K1: the ogbn-arxiv
proxy, PlanConfig(128, 128)) and B (K2: the same graph,
PlanConfig(2048, 128, block_unroll=4, cluster_cols=True)), at d 128 and
256.

    python3 -m voltrix_spmm_tpu_torch.tools.spmm_piece_sweep

Needs one CUDA device. Each (kernel, width, limits) is timed twice with
CUDA events (mean of 20 launches after 3 warm-up), the settings in turns:
up, then down. Beside each: the workspace, and the time of the plan cut
to its heaviest window alone (the hub window's pieces, the path that one
window sets). torch.sparse.mm on the CSR is timed once per width as the
yardstick. Features are random normal, made from a seed.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from .. import PlanConfig, csr_preprocess
from ..data import proxy_csr, symmetrize
from ..ops import block_spmm, spmm_block, spmm_subtile
from ..ops.subtile_spmm import subtile_walk
from .k6_task_sweep import cuda_ms

BLOCKS = (8, 16, 32, 64)
WORK = (512, 1024, 2048, 4096, 8192)
WIDTHS = (128, 256)


def heaviest_window(plan):
    """`plan` cut to its window with the most blocks (rows past it dropped)."""
    bp = plan.block_ptr.cpu()
    w = int(torch.diff(bp).argmax())
    b0, b1 = int(bp[w]), int(bp[w + 1])
    h = plan.config.block_h
    return w, dataclasses.replace(
        plan, bitmask=plan.bitmask[b0:b1], hind=plan.hind[b0:b1],
        window_of_block=plan.window_of_block[b0:b1] - w,
        block_ptr=torch.tensor([0, b1 - b0], dtype=torch.int32, device=plan.device),
        occ=None if plan.occ is None else plan.occ[b0:b1],
        num_nodes=min((w + 1) * h, plan.num_nodes) - w * h, num_edges=0, num_windows=1,
        total_blocks=b1 - b0, has_empty_windows=False, num_cols=plan.source_rows)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("spmm_piece_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    n = arxiv.shape[0]
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(arxiv.indptr).long(), torch.from_numpy(arxiv.indices).long(),
        torch.ones(arxiv.nnz), size=arxiv.shape).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = {d: torch.randn(n, d, device=dev, generator=gen) for d in WIDTHS}
    for d, x in feats.items():
        print(f"torch.sparse.mm d {d}: {cuda_ms(lambda x=x: torch.sparse.mm(csr, x)):.4f} ms")
    cases = []
    for name, kernel, cfg, walk in (
            ("spmm_block", spmm_block, PlanConfig(128, 128),
             lambda p: block_spmm.plan_walk(p, "spmm_block")),
            ("spmm_subtile", spmm_subtile,
             PlanConfig(2048, 128, block_unroll=4, cluster_cols=True), subtile_walk)):
        plan = csr_preprocess(arxiv.indptr, arxiv.indices, n, cfg).to(dev)
        w, hub = heaviest_window(plan)
        print(f"{name}: {cfg}, {plan.total_blocks} blocks; heaviest window {w}: "
              f"{hub.total_blocks} blocks")
        for d, x in feats.items():
            cases.append((name, d, lambda k=kernel, p=plan, x=x: k(p, x),
                          lambda k=kernel, p=hub, x=x: k(p, x), plan, walk))
    defaults = dict(block_spmm.PIECE_BLOCKS), dict(block_spmm.PIECE_WORK)
    settings = [(pb, pw) for pb in BLOCKS for pw in WORK]
    times: dict = {}
    try:
        for order in (settings, settings[::-1]):
            for pb, pw in order:
                for name, d, whole, alone, plan, walk in cases:
                    block_spmm.PIECE_BLOCKS[name], block_spmm.PIECE_WORK[name] = pb, pw
                    key = (name, d, pb, pw)
                    if key not in times:
                        st = block_spmm.walk_stats(plan, walk(plan), d)
                        times[key] = {"stats": st, "ms": [], "hub_ms": []}
                    times[key]["ms"].append(cuda_ms(whole))
                    times[key]["hub_ms"].append(cuda_ms(alone))
    finally:
        for current, default in zip((block_spmm.PIECE_BLOCKS, block_spmm.PIECE_WORK), defaults):
            current.clear()
            current.update(default)
    for (name, d, pb, pw), t in sorted(times.items()):
        st = t["stats"]
        print(f"{name} d{d} PIECE_BLOCKS {pb} PIECE_WORK {pw}: {t['ms'][0]:.4f} / "
              f"{t['ms'][1]:.4f} ms; heaviest window alone {t['hub_ms'][0]:.4f} / "
              f"{t['hub_ms'][1]:.4f} ms; {st['pieces']} pieces, heaviest {st['max_task_work']} "
              f"units of work (mean {st['mean_task_work']:.1f}); workspace "
              f"{st['workspace_mib']:.2f} MiB")


if __name__ == "__main__":
    main()

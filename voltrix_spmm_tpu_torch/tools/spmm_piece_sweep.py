"""Kernels K1, K2, K3, K4, K5 and K8 against their piece limits
(PIECE_BLOCKS, the most blocks of one window a thread block walks, and
PIECE_WORK, about the most work; K4 and K5 have no work limit), at the
shapes of chip_smoke.py's paths A (K1: the ogbn-arxiv proxy,
PlanConfig(128, 128)) and B (K2: the same graph, PlanConfig(2048, 128,
block_unroll=4, cluster_cols=True)), at d 128 and 256, D (K4: the same
graph with self-loops, PlanConfig(64, 128), value planes of A and A^T from
one attention vector, at d 8 and 40; K5 on A's plan at d 8 and 40), I (K8
alone on A's plan at d 128 and 256, and on path C's plan: the protein
proxy, PlanConfig(2048, 128, gather_segment=128, block_unroll=4), at
d 256), C (K3 on C's plan at d 8 and 256) and J.2 (K3 on the dense side of
the JAX package's default hybrid plan of A's graph, PlanConfig(128, 128,
8), at d 128 and 256).

    python3 -m voltrix_spmm_tpu_torch.tools.spmm_piece_sweep [--kernels spmm_weighted ...]

Needs one CUDA device; K8's and K3's cases build C's plan (~40 s of host
time). Each (kernel, width, limits) is timed twice with
CUDA events (mean of 20 launches after 3 warm-up), the settings in turns:
up, then down. Beside each: the workspace, and the time of the plan cut
to its heaviest window alone (the hub window's pieces, the path that one
window sets). torch.sparse.mm on the CSR is timed once per width as the
yardstick. Features and attention values are random, made from a seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import PlanConfig, build_gat_graph, csr_preprocess, csr_preprocess_hybrid
from ..data import proxy_csr, symmetrize
from ..ops import (block_spmm, quant, spmm_block, spmm_fused, spmm_subtile, spmm_weighted,
                   spmm_weighted_dvalues)
from ..ops.subtile_spmm import subtile_walk
from .k6_piece_sweep import cuda_ms

KERNELS = ("spmm_block", "spmm_subtile", "spmm_int8", "spmm_weighted", "spmm_fused",
           "spmm_dvalues")
# the limits swept, by kernel: K8 and K3 also walk C's 64-word windows,
# where small pieces cost gigabytes of workspace (K3's pieces may pass
# MAX_PIECE_BLOCKS: 4096 leaves C's windows uncut); K4 and K5 have a block
# limit alone
BLOCKS = {"spmm_block": (8, 16, 32, 64), "spmm_subtile": (8, 16, 32, 64),
          "spmm_int8": (16, 32, 64, 128, 256), "spmm_weighted": (2, 4, 8, 16, 32, 64),
          "spmm_fused": (256, 1024, 4096), "spmm_dvalues": (1, 2, 4, 8, 16)}
WORK = {"spmm_block": (512, 1024, 2048, 4096, 8192),
        "spmm_subtile": (512, 1024, 2048, 4096, 8192),
        "spmm_int8": (1024, 2048, 4096, 8192, 16384), "spmm_weighted": (None,),
        "spmm_fused": (None, 4096, 8192, 16384, 32768, 65536), "spmm_dvalues": (None,)}
NO_WORKSPACE = ("spmm_dvalues",)  # K5 writes every block's plane once, with no merge
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
        values=None if plan.values is None else plan.values[b0:b1],
        num_nodes=min((w + 1) * h, plan.num_nodes) - w * h, num_edges=0, num_windows=1,
        total_blocks=b1 - b0, has_empty_windows=False, num_cols=plan.source_rows)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    kernels = parser.parse_args().kernels
    if not torch.cuda.is_available():
        raise SystemExit("spmm_piece_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def add(name, label, plan, d, run):
        """Time `run(plan)` whole and on the plan's heaviest window alone."""
        w, hub = heaviest_window(plan)
        print(f"{name} {label} d{d}: {plan.config}, {plan.total_blocks} blocks; heaviest window "
              f"{w}: {hub.total_blocks} blocks")
        walk = (subtile_walk if name == "spmm_subtile"
                else lambda p, name=name: block_spmm.plan_walk(p, name))
        cases.append((name, label, d, lambda: run(plan), lambda: run(hub), plan, walk))

    def sparse_mm(a, x, label):
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr).long(), torch.from_numpy(a.indices).long(),
            torch.ones(a.nnz), size=a.shape).to(dev)
        print(f"torch.sparse.mm on {label} d {x.shape[1]}: "
              f"{cuda_ms(lambda: torch.sparse.mm(csr, x)):.4f} ms")
        del csr

    n = arxiv.shape[0]
    feats = {d: torch.randn(n, d, device=dev, generator=gen) for d in WIDTHS}
    for d, x in feats.items():
        sparse_mm(arxiv, x, "A")
    for name, kernel, cfg in (
            ("spmm_block", spmm_block, PlanConfig(128, 128)),
            ("spmm_subtile", spmm_subtile,
             PlanConfig(2048, 128, block_unroll=4, cluster_cols=True))):
        if name in kernels:
            plan = csr_preprocess(arxiv.indptr, arxiv.indices, n, cfg).to(dev)
            for d, x in feats.items():
                add(name, "A's graph", plan, d, lambda p, k=kernel, x=x: k(p, x))
    if "spmm_int8" in kernels:
        plan = csr_preprocess(arxiv.indptr, arxiv.indices, n, PlanConfig(128, 128)).to(dev)
        for d, x in feats.items():
            q, sc = quant.quantize_padded(x)
            add("spmm_int8", "I (A's plan)", plan, d,
                lambda p, q=q, sc=sc, d=d: quant.launch_quantized(p, q, sc, d))
    if "spmm_fused" in kernels:
        dense = csr_preprocess_hybrid(arxiv.indptr, arxiv.indices, n).dense.to(dev)
        for d, x in feats.items():
            add("spmm_fused", "J.2 (the hybrid plan's dense side)", dense, d,
                lambda p, x=x: spmm_fused(p, x))
    if "spmm_int8" in kernels or "spmm_fused" in kernels:
        protein = symmetrize(proxy_csr("protein", seed=0))
        xc = {d: torch.randn(protein.shape[0], d, device=dev, generator=gen) for d in (8, 256)}
        sparse_mm(protein, xc[256], "C")
        plan_c = csr_preprocess(protein.indptr, protein.indices, protein.shape[0],
                                PlanConfig(2048, 128, gather_segment=128, block_unroll=4)).to(dev)
        del protein
        if "spmm_int8" in kernels:
            q, sc = quant.quantize_padded(xc[256])
            add("spmm_int8", "C's plan", plan_c, 256,
                lambda p, q=q, sc=sc: quant.launch_quantized(p, q, sc, 256))
        if "spmm_fused" in kernels:
            for d, x in xc.items():
                add("spmm_fused", "C's plan", plan_c, d, lambda p, x=x: spmm_fused(p, x))
    if "spmm_weighted" in kernels or "spmm_dvalues" in kernels:
        loops = ((arxiv + sp.eye(n, format="csr")) != 0).astype(np.float32).tocsr()
        loops.sort_indices()
        g = build_gat_graph(loops.indptr, loops.indices, n, PlanConfig(64, 128), device=dev)
        alpha = torch.rand(loops.nnz, device=dev, generator=gen)
        for side, p, slots in (("D's A", g.plan, g.slots), ("D's A^T", g.plan_t, g.slots_t)):
            H, K = p.config.block_h, p.config.block_w
            plane = torch.zeros(p.total_blocks * H * K, device=dev).index_add_(0, slots, alpha)
            wplan = dataclasses.replace(p, values=plane.view(-1, H, K))
            for d in (8, 40):
                x = torch.randn(n, d, device=dev, generator=gen)
                if "spmm_weighted" in kernels:
                    add("spmm_weighted", side, wplan, d, lambda p, x=x: spmm_weighted(p, x))
                if "spmm_dvalues" in kernels and side == "D's A":
                    # the hub window alone takes the first rows of dO (timing only)
                    dout = torch.randn(n, d, device=dev, generator=gen)
                    add("spmm_dvalues", side, wplan, d,
                        lambda p, x=x, dout=dout: spmm_weighted_dvalues(p, x, dout[:p.num_nodes]))
        del g, loops
    defaults = dict(block_spmm.PIECE_BLOCKS), dict(block_spmm.PIECE_WORK)
    times: dict = {}
    try:
        for name in kernels:
            settings = [(pb, pw) for pb in BLOCKS[name] for pw in WORK[name]]
            for order in (settings, settings[::-1]):
                for pb, pw in order:
                    block_spmm.PIECE_BLOCKS[name], block_spmm.PIECE_WORK[name] = pb, pw
                    for kname, label, d, whole, alone, plan, walk in cases:
                        if kname != name:
                            continue
                        key = (name, label, d, pb, pw)
                        if key not in times:
                            st = block_spmm.walk_stats(plan, walk(plan), d)
                            times[key] = {"stats": st, "ms": [], "hub_ms": []}
                        times[key]["ms"].append(cuda_ms(whole))
                        times[key]["hub_ms"].append(cuda_ms(alone))
                    torch.cuda.empty_cache()  # the last setting's workspace
    finally:
        for current, default in zip((block_spmm.PIECE_BLOCKS, block_spmm.PIECE_WORK), defaults):
            current.clear()
            current.update(default)
    for (name, label, d, pb, pw), t in sorted(times.items(),
                                              key=lambda kv: (*kv[0][:4], kv[0][4] or 0)):
        st = t["stats"]
        if name in NO_WORKSPACE:
            st["workspace_mib"] = 0.0
        print(f"{name} {label} d{d} PIECE_BLOCKS {pb} PIECE_WORK {pw}: {t['ms'][0]:.4f} / "
              f"{t['ms'][1]:.4f} ms; heaviest window alone {t['hub_ms'][0]:.4f} / "
              f"{t['hub_ms'][1]:.4f} ms; {st['pieces']} pieces, heaviest {st['max_task_work']} "
              f"units of work (mean {st['mean_task_work']:.1f}); workspace "
              f"{st['workspace_mib']:.2f} MiB")


if __name__ == "__main__":
    main()

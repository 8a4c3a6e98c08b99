"""Where `build_graph(config="auto")` should start to take K3's coverage
plan: the tuner's race of K3 (PlanConfig(2048, 128, gather_segment=128,
block_unroll=4)) against K1 on 128-row windows and K2 on clustered 1024-
and 2048-row windows, on uniform random graphs of the protein and ogbl-ddi
proxies' family (`data/real.py:proxy_csr` "dense": sp.random at 300 edges
a row, symmetrized, about 600 a row) from F's 4,267 rows up, at d 128 and
256. Beside each candidate's time: its device peak over one call
(`torch.cuda.max_memory_allocated`, plan, work list, workspace, features
and output) and the tuner's estimate of it (`estimate_residency`).

    python3 -m voltrix_spmm_tpu_torch.tools.auto_sweep [--sizes 4267 8192 ...]
        [--widths 128 256] [--degree 300] [--isolate] [--out sweep.json]

Needs one CUDA device. Each race is the tuner's own (`SpmmTuner`, in
process or, with --isolate, a probe process a candidate; a fresh cache in
a temporary directory): `utils.gpu_bench`, the
median of 8 CUDA-event launches after a 256 MiB L2 flush. Graphs are made
from a seed; the largest default size (65,536 rows, 39M nnz) takes about
10 s of host time to make.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np

SIZES = (4267, 8192, 16384, 24576, 32768, 49152, 65536)


def sweep_space():
    from ..tuner import Variant

    return [Variant("fused", block_h=2048, gather_segment=128, block_unroll=4),
            Variant("pregather", block_h=128),
            Variant("pregather", block_h=1024, block_unroll=4, subtile=True),
            Variant("pregather", block_h=2048, block_unroll=4, subtile=True)]


def race_size(n: int, widths, degree: int, seed: int, cache_dir: str, device="cuda",
              isolate: bool = False) -> list[dict]:
    import torch

    from ..data import erdos_renyi_csr, symmetrize
    from ..format.preprocess import FUSED_COVERAGE_THRESHOLD, coverage_expansion
    from ..models.graph import auto_plan_config
    from ..tuner import SpmmTuner
    from ..tuner.tuner import estimate_lanes, estimate_residency

    t0 = time.perf_counter()
    a = symmetrize(erdos_renyi_csr(n, degree / n, seed=seed + n))
    gen_s = time.perf_counter() - t0
    nnz = a.nnz
    cov = coverage_expansion(a.indptr, a.indices, n, 2048, 128)
    rows512 = coverage_expansion(a.indptr, a.indices, n, 512, 1) * nnz
    rows2048 = coverage_expansion(a.indptr, a.indices, n, 2048, 1) * nnz
    auto = auto_plan_config(a.indptr, a.indices, n)
    rng = np.random.default_rng(seed)
    rows = []
    for d in widths:
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
        tuned = SpmmTuner(cache_dir=cache_dir).compile_and_tune(
            a.indptr, a.indices, n, x, space=sweep_space(), isolate=isolate,
            hash_tag=f"auto-sweep-{n}-{seed}{'-iso' if isolate else ''}", device=device)
        cands = {}
        for key, ms in tuned.candidates.items():
            v = tuned.variants[key][1]
            est = estimate_residency(v, num_nodes=n, d=d, nnz=nnz,
                                     lanes=estimate_lanes(v, nnz, cov, rows512, rows2048))
            cands[v.key()] = {"ms": ms, "peak_gib": tuned.peak_bytes.get(key, 0) / 2**30,
                              "estimate_gib": est / 2**30}
        k3 = sweep_space()[0].key()
        rest = min(c["ms"] for k, c in cands.items() if k != k3)
        rows.append({"n": n, "d": d, "isolate": isolate, "nnz": nnz,
                     "windows_2048": -(-n // 2048),
                     "coverage128": cov, "gate": cov <= FUSED_COVERAGE_THRESHOLD,
                     "auto": str(auto), "winner": tuned.variant.key(),
                     "k3_over_best_other": cands[k3]["ms"] / rest, "graph_s": gen_s,
                     "candidates": cands})
        del tuned, x
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--widths", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--degree", type=int, default=300,
                    help="edges a row before symmetrizing (the proxies' 300)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--isolate", action="store_true",
                    help="time each candidate in a probe process (tuner/probe.py)")
    ap.add_argument("--out", default=None, help="also write the rows here as JSON")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"auto_sweep on {smi}")
    rows = []
    with tempfile.TemporaryDirectory(prefix="voltrix_auto_sweep_") as cache_dir:
        for n in args.sizes:
            for r in race_size(n, args.widths, args.degree, args.seed, cache_dir,
                               isolate=args.isolate):
                rows.append(r)
                print(f"n {r['n']} ({r['windows_2048']} windows of 2048) d {r['d']}"
                      f"{' isolated' if r['isolate'] else ''}: nnz "
                      f"{r['nnz']}, coverage {r['coverage128']:.3f} (gate {r['gate']}), "
                      f"winner {r['winner']}, K3 over the best other "
                      f"{r['k3_over_best_other']:.3f}; auto {r['auto']}", flush=True)
                for k, c in r["candidates"].items():
                    print(f"    {k}: {c['ms']:.4f} ms, peak {c['peak_gib']:.3f} GiB, estimate "
                          f"{c['estimate_gib']:.3f} GiB", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    print(json.dumps({"device": smi, "rows": rows}))


if __name__ == "__main__":
    main()

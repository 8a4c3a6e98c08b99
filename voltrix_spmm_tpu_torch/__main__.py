"""Command-line interface: ``python -m voltrix_spmm_tpu_torch <cmd> ...``
(counterpart of voltrix_spmm_tpu/__main__.py, with its commands, flags
and graph specs):

    info                    environment / device / build report
    preprocess GRAPH -o P   build + save an SpmmPlan from a graph
    validate PLAN           check plan invariants (format.diagnostics)
    tune GRAPH -d D         race the tuner's default space on --device
                            (default cuda) and report the winning variant
    spmm GRAPH -d D         run one SpMM (random features) on --device
                            (default cuda), check it against scipy, and
                            with --time time it with CUDA events

GRAPH is an .npz in either this repo's indptr/indices layout
(data.save_npz_graph) or the TC-GNN src_li/dst_li layout, or one of the
synthetic names er-<nodes> / rmat-<scale> / dense-<nodes>.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_graph(spec: str):
    """Resolve a graph spec: a path to .npz, or a synthetic name."""
    import scipy.sparse as sp

    if spec.endswith(".npz"):
        from .data.real import load_tcgnn_npz

        return load_tcgnn_npz(spec), spec
    from .data import erdos_renyi_csr, rmat_csr, symmetrize

    kind, _, arg = spec.partition("-")
    if kind == "er":
        n = int(arg or 8192)
        return symmetrize(erdos_renyi_csr(n, 0.002, seed=0)), spec
    if kind == "rmat":
        scale = int(arg or 15)
        return symmetrize(rmat_csr(scale, 16, seed=0)), spec
    if kind == "dense":
        n = int(arg or 4096)
        a = sp.random(n, n, density=0.08, format="csr", random_state=0)
        return (a != 0).astype(np.float32).tocsr(), spec
    raise SystemExit(
        f"unknown graph spec {spec!r}: pass an .npz path or "
        "er-<nodes> / rmat-<scale> / dense-<nodes>"
    )


def _config_from_args(args):
    from .format import PlanConfig

    return PlanConfig(
        block_h=args.block_h,
        block_w=args.block_w,
        gather_segment=args.seg,
        block_unroll=args.unroll,
        cluster_cols=args.cluster,
    )


def _add_plan_args(p):
    p.add_argument("--block-h", type=int, default=128)
    p.add_argument("--block-w", type=int, default=128)
    p.add_argument("--seg", type=int, default=1)
    p.add_argument("--unroll", type=int, default=1)
    p.add_argument("--cluster", action="store_true")


def cmd_info(args) -> int:
    import torch

    from . import __version__
    from .jit import get_build_dir, get_cxx, get_nvcc
    from .project import const
    from .runtime.native import native_available

    def found(get):
        try:
            return get()
        except RuntimeError:
            return None

    cuda = torch.cuda.is_available()
    info = {
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvcc": found(get_nvcc),
        "cxx": found(get_cxx),
        "native_runtime": bool(native_available()),
        "build_dir": get_build_dir(),
        "env_flags": {name: getattr(const, name) for name in dir(const)
                      if name.endswith("_FLAG")},
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_preprocess(args) -> int:
    import time

    from .format import csr_preprocess, plan_stats
    from .format.cluster import packed_stats

    a, name = _load_graph(args.graph)
    cfg = _config_from_args(args)
    t0 = time.time()
    plan = csr_preprocess(a.indptr, a.indices, a.shape[0], cfg, backend=args.backend)
    build_s = time.time() - t0
    out = args.output or (name.removesuffix(".npz") + ".plan.npz")
    plan.save(out, packed=args.packed)
    stats = plan_stats(plan)
    rec = {
        "graph": name,
        "num_nodes": int(plan.num_nodes),
        "nnz": int(a.nnz),
        "total_blocks": int(plan.total_blocks),
        "build_s": round(build_s, 3),
        "fill_ratio": round(float(stats["fill_ratio"]), 6),
        "plan_path": out,
    }
    if args.packed and cfg.block_h % 128 == 0:
        rec["packed"] = packed_stats(plan.bitmask)
    print(json.dumps(rec))
    return 0


def cmd_validate(args) -> int:
    from .format import SpmmPlan
    from .format.diagnostics import PlanInvariantError, validate_plan

    plan = SpmmPlan.load(args.plan)
    try:
        validate_plan(plan)
    except PlanInvariantError as e:
        print(f"INVALID: {e}")
        return 1
    print(f"ok: {plan.num_nodes} nodes, {plan.total_blocks} blocks, config {plan.config}")
    return 0


def cmd_tune(args) -> int:
    from .tuner import tune_spmm

    a, name = _load_graph(args.graph)
    feat = np.zeros((a.shape[0], args.d), np.float32)
    tuned = tune_spmm(a.indptr, a.indices, a.shape[0], feat, iters=args.iters, hash_tag=name,
                      budget_s=args.budget_s, reorderings=tuple(args.reorder),
                      device=args.device)
    print(json.dumps({
        "graph": name,
        "d": args.d,
        "device": args.device,
        "variant": str(tuned.variant),
        "ordering": tuned.ordering,
        "time_ms": round(float(tuned.time_ms), 4),
        "candidates": len(tuned.candidates),
    }))
    return 0


def cmd_spmm(args) -> int:
    import torch

    from . import calc_diff, csr_preprocess, spmm
    from .ops import spmm_scipy

    a, name = _load_graph(args.graph)
    cfg = _config_from_args(args)
    dev = torch.device(args.device)
    plan = csr_preprocess(a.indptr, a.indices, a.shape[0], cfg).to(dev)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((a.shape[0], args.d)).astype(np.float32)
    x = torch.from_numpy(feat).to(dev)
    out = spmm(plan, x)
    diff = calc_diff(out, spmm_scipy(a.indptr, a.indices, a.shape[0], feat))
    rec = {"graph": name, "d": args.d, "device": str(dev), "difference_rate": float(diff)}
    if args.time:
        if dev.type != "cuda":
            rec["note"] = "timing skipped on the CPU"
        else:
            for _ in range(3):
                spmm(plan, x)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                spmm(plan, x)
            end.record()
            end.synchronize()
            rec["ms"] = start.elapsed_time(end) / 20
            rec["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(rec))
    return 0 if diff < 1e-4 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m voltrix_spmm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="environment / device / build report")

    pp = sub.add_parser("preprocess", help="build + save an SpmmPlan")
    pp.add_argument("graph")
    pp.add_argument("-o", "--output")
    pp.add_argument("--backend", default="auto", choices=("auto", "native", "numpy"))
    pp.add_argument("--packed", action="store_true",
                    help="save occupied sub-tiles only (smaller file)")
    _add_plan_args(pp)

    pv = sub.add_parser("validate", help="check plan invariants")
    pv.add_argument("plan")

    pt = sub.add_parser("tune", help="autotune and report the winner")
    pt.add_argument("graph")
    pt.add_argument("-d", type=int, default=256)
    pt.add_argument("--iters", type=int, default=8)
    pt.add_argument("--budget", "--budget-s", dest="budget_s", type=float, default=None,
                    help="soft tuning budget in seconds")
    pt.add_argument("--reorder", nargs="+", default=["identity"],
                    choices=("identity", "rcm", "degree"), help="orderings to race")
    pt.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    ps = sub.add_parser("spmm", help="run one SpMM and check vs scipy")
    ps.add_argument("graph")
    ps.add_argument("-d", type=int, default=256)
    ps.add_argument("--time", action="store_true")
    ps.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _add_plan_args(ps)

    args = p.parse_args(argv)
    return {
        "info": cmd_info,
        "preprocess": cmd_preprocess,
        "validate": cmd_validate,
        "tune": cmd_tune,
        "spmm": cmd_spmm,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

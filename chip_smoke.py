#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voltrix_spmm_tpu_torch) on one
NVIDIA GPU of the Hopper generation (sm_90a, an H100).

    python3 chip_smoke.py

It imports neither jax nor the JAX package. Phases, each of which exits
non-zero on failure (there is no CPU fallback):

1. Device: the card's name and count, and nvidia-smi's name and power
   limit. No CUDA device -> exit 1 before anything else.
2. Build: kernel K1 (csrc/spmm_block.cu) with nvcc into build/kernels/.
3. Kernel against its plain version on the card, on several plan
   geometries: calc_diff < 1e-6 and allclose(rtol=1e-5, atol=1e-4)
   (float32 sums in another order, so not bit-equal).
4. The slice: the ogbn-arxiv proxy (169,343 nodes), PlanConfig(128, 128),
   a GCN 128 -> 256 -> 40 from seeded parameters, serving 3 requests
   through gcn_forward. K1 must launch exactly twice per request and
   the plain version never; the logits must match the same forward with
   impl="reference" (rtol=1e-4, atol=1e-4) and a float64 host forward.
5. Timing with CUDA events: K1 and the plain version per SpMM at the
   slice's widths (d=128, d=256), and per request.

The second-to-last line is a JSON object describing each kernel; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:51-52
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
REQUESTS = 3


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import torch

    # --- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from voltrix_spmm_tpu_torch import (
        GCN, PlanConfig, build_graph, calc_diff, csr_preprocess, gcn_params_from_jax,
    )
    from voltrix_spmm_tpu_torch.data import erdos_renyi_csr, proxy_csr, symmetrize
    from voltrix_spmm_tpu_torch.format import plan_stats
    from voltrix_spmm_tpu_torch.jit import get_build_dir
    from voltrix_spmm_tpu_torch.ops import spmm_block, spmm_reference
    from voltrix_spmm_tpu_torch.ops.block_spmm import load_library

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {kind} (count {count}); nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 is off for matmul and cudnn: dense products run in full float32")

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    load_library()
    print(f"build: csrc/spmm_block.cu for sm_90a in {time.perf_counter() - t0:.2f} s "
          f"into {get_build_dir()}")

    # --- 3. kernel against the plain version ----------------------------
    max_err = 0.0

    def compare(name, plan, feat, deg=None):
        """K1 against the plain version. With `deg` (row degrees) the
        allowance of each row also holds the textbook bound on float32
        summation in any order, (deg - 1) * 2**-24 * sum|x|, once for each
        version: hub rows of a power-law graph sum tens of thousands of
        terms, and the test_spmm tolerance is set for small degrees."""
        nonlocal max_err
        out_k = spmm_block(plan, feat)
        out_p = spmm_reference(plan, feat)
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape or not bool(torch.isfinite(out_k).all()):
            fail(f"{name}: kernel output {tuple(out_k.shape)} is not a finite "
                 f"{tuple(out_p.shape)}")
        diff = calc_diff(out_k, out_p)
        err = (out_k - out_p).abs().max().item() if out_k.numel() else 0.0
        max_err = max(max_err, err)
        allow = TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * out_p.abs()
        if deg is not None:
            abs_sum = spmm_reference(plan, feat.abs())
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        ok = diff < 1e-6 and bool(((out_k - out_p).abs() <= allow).all())
        print(f"  {name}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e} "
              f"-> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel K1 disagrees with its plain version on {name}")

    rng = np.random.default_rng(0)

    def feat_of(n, d):
        return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def case(name, a, n, d, cfg, expect=None):
        plan = csr_preprocess(a.indptr, a.indices, n, cfg)
        if expect is not None and not expect(plan):
            fail(f"{name}: the plan lacks the property this case is for")
        compare(name, plan.to(dev), feat_of(n, d))

    def rows_only(a, keep):
        a = a.tolil()
        for r in range(a.shape[0]):
            if not keep(r):
                a.rows[r], a.data[r] = [], []
        return a.tocsr()

    print("kernel K1 against the plain version (calc_diff < 1e-6, "
          f"allclose {TOL_KERNEL}):")
    case("n3000 d300 PlanConfig(128,128), bit 31 set", erdos_renyi_csr(3000, 0.02, 1),
         3000, 300, PlanConfig(128, 128), expect=lambda p: bool((p.bitmask < 0).any()))
    case("n1000 d64 PlanConfig(32,128,block_unroll=4)", erdos_renyi_csr(1000, 0.02, 2),
         1000, 64, PlanConfig(32, 128, block_unroll=4))
    case("n1000 d256 PlanConfig(128,256)", erdos_renyi_csr(1000, 0.01, 3),
         1000, 256, PlanConfig(128, 256))
    case("n700 d72 PlanConfig(48,128) (block_h not a multiple of 32)",
         erdos_renyi_csr(700, 0.02, 4), 700, 72, PlanConfig(48, 128))
    case("n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 5), lambda r: not 256 <= r < 512),
         2048, 96, PlanConfig(128, 128),
         expect=lambda p: not p.has_empty_windows and bool((p.bitmask.view(p.total_blocks, -1) == 0).all(1).any()))
    case("n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 6), lambda r: r < 128),
         10240, 128, PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
    case("n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 7), 500, 64,
         PlanConfig(128, 128), expect=lambda p: p.total_blocks == 0)
    case("n1001 d40 PlanConfig(128,128,gather_segment=4)", erdos_renyi_csr(1001, 0.01, 8),
         1001, 40, PlanConfig(128, 128, gather_segment=4),
         expect=lambda p: int(p.hind.max()) >= 1001)

    # --- 4. the slice: GCN serving on the ogbn-arxiv proxy --------------
    t0 = time.perf_counter()
    a = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    n = a.shape[0]
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_graph(a.indptr, a.indices, n, PlanConfig(128, 128), symmetric=True, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    stats = plan_stats(g.plan)
    bpw = torch.diff(g.plan.block_ptr)
    print(f"slice: ogbn-arxiv proxy, {n} nodes, {stats['nnz']} nnz, "
          f"{stats['num_windows']} windows, {stats['total_blocks']} blocks "
          f"(largest window {int(bpw.max())}), fill {stats['fill_ratio']:.4f}; "
          f"graph {t_gen:.2f} s, build_graph {t_build:.2f} s")
    plan_tensors = ("bitmask", "hind", "window_of_block", "block_ptr")
    if not (all(getattr(g.plan, f).is_cuda for f in plan_tensors)
            and g.plan_t is g.plan and g.inv_deg.is_cuda):
        fail("the plan is not on the card before the first request")

    in_dim, hidden, classes = 128, 256, 40
    prng = np.random.default_rng(1)
    params_np = {
        "w1": prng.standard_normal((in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
        "b1": prng.standard_normal(hidden) * 0.1,
        "w2": prng.standard_normal((hidden, classes)) * (2.0 / hidden) ** 0.5,
        "b2": prng.standard_normal(classes) * 0.1,
    }
    model = GCN.from_params(gcn_params_from_jax(params_np, dev)).eval()
    xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
    torch.cuda.synchronize()

    spmm_block.launches = 0
    spmm_reference.calls = 0
    logits, wall_ms = [], []
    with torch.no_grad():
        for x in xs:
            t0 = time.perf_counter()
            logits.append(model(g, x))
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
    launches, plain_calls = spmm_block.launches, spmm_reference.calls
    print(f"served {REQUESTS} requests: K1 launches {launches}, plain calls "
          f"{plain_calls}; host ms per request {[round(t, 3) for t in wall_ms]}")
    if launches != 2 * REQUESTS or plain_calls != 0:
        fail(f"main path ran K1 {launches} times (want {2 * REQUESTS}) and the "
             f"plain version {plain_calls} times (want 0)")

    with torch.no_grad():
        for i, (x, out) in enumerate(zip(xs, logits)):
            ref = model(g, x, impl="reference")
            torch.cuda.synchronize()
            ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                  and torch.allclose(out, ref, **TOL_LOGITS))
            print(f"  request {i}: logits {tuple(out.shape)}, max|K1 - plain| "
                  f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"request {i}: logits disagree with the plain forward")
    # independent float64 host forward of request 0 (scipy CSR)
    a64 = a.astype(np.float64)
    inv_deg = 1.0 / np.maximum(np.asarray(a64.sum(axis=1)), 1.0)
    x0 = xs[0].cpu().double().numpy()
    h = np.maximum((inv_deg * (a64 @ x0)) @ params_np["w1"] + params_np["b1"], 0.0)
    host = (inv_deg * (a64 @ h)) @ params_np["w2"] + params_np["b2"]
    host_err = float(np.abs(logits[0].cpu().double().numpy() - host).max())
    print(f"  request 0 against a float64 host forward: max|diff| {host_err:.3e}")
    if not np.allclose(logits[0].cpu().double().numpy(), host, **TOL_LOGITS):
        fail("request 0 disagrees with the float64 host forward")

    # --- 5. timing ------------------------------------------------------
    widths = {}
    deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
    for d in (in_dim, hidden):
        feat = xs[0] if d == in_dim else feat_of(n, d)
        compare(f"ogbn-arxiv proxy d{d} (float32 summation bound)", g.plan, feat, deg)
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(torch, lambda: spmm_reference(g.plan, feat), iters=5)
        k1 = cuda_ms(torch, lambda: spmm_block(g.plan, feat))
        k2 = cuda_ms(torch, lambda: spmm_block(g.plan, feat))
        p2 = cuda_ms(torch, lambda: spmm_reference(g.plan, feat), iters=5)
        widths[d] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  SpMM d={d}: K1 {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    with torch.no_grad():
        x = xs[0]
        rp1 = cuda_ms(torch, lambda: model(g, x, impl="reference"), iters=5)
        rk1 = cuda_ms(torch, lambda: model(g, x))
        rk2 = cuda_ms(torch, lambda: model(g, x))
        rp2 = cuda_ms(torch, lambda: model(g, x, impl="reference"), iters=5)
    req_ms, plain_req_ms = (rk1 + rk2) / 2, (rp1 + rp2) / 2
    print(f"timing on {smi} (CUDA events, mean of 20 launches after 3 warm-up; "
          "plain 5):")
    for d, (k, p) in widths.items():
        print(f"  per SpMM d={d}: K1 {k:.4f} ms, plain {p:.4f} ms")
    print(f"  per request (GCN forward): K1 path {req_ms:.4f} ms "
          f"({rk1:.4f} / {rk2:.4f}), plain path {plain_req_ms:.4f} ms "
          f"({rp1:.4f} / {rp2:.4f})")

    if "jax" in sys.modules or "voltrix_spmm_tpu" in sys.modules:
        fail("jax or the JAX package was imported")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "spmm_block",
        "route": "cuda",
        "source": "voltrix_spmm_tpu_torch/csrc/spmm_block.cu",
        "replaces": "voltrix_spmm_tpu/ops/pallas_spmm.py:165",
        "launches": launches,
        "max_abs_err": max_err,
        # ms / plain_ms: the request's two SpMMs, d=128 plus d=256
        "ms": widths[in_dim][0] + widths[hidden][0],
        "plain_ms": widths[in_dim][1] + widths[hidden][1],
        "ms_d128": widths[in_dim][0],
        "ms_d256": widths[hidden][0],
        "plain_ms_d128": widths[in_dim][1],
        "plain_ms_d256": widths[hidden][1],
        "request_ms": req_ms,
        "plain_request_ms": plain_req_ms,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voltrix_spmm_tpu_torch) on one
NVIDIA GPU of the Hopper generation (sm_90a, an H100).

    python3 chip_smoke.py

It imports neither jax nor the JAX package. Phases, each of which exits
non-zero on failure (there is no CPU fallback):

1. Device: the card's name and count, and nvidia-smi's name and power
   limit. No CUDA device -> exit 1 before anything else.
2. Build: kernels K1 (csrc/spmm_block.cu), K2 (csrc/spmm_subtile.cu) and
   K3 (csrc/spmm_fused.cu), one nvcc each, all started together, into
   build/kernels/.
3. Each kernel against its plain version on the card, on several plan
   geometries: calc_diff < 1e-6 and allclose(rtol=1e-5, atol=1e-4)
   (float32 sums in another order, so not bit-equal).
4. Three serving paths, each a GCN from seeded parameters answering 3
   requests through GCN.forward (gcn_forward -> aggregate -> spmm_ad):
   A. the ogbn-arxiv proxy (169,343 nodes), PlanConfig(128, 128),
      128 -> 256 -> 40: K1;
   B. the same graph, PlanConfig(2048, 128, block_unroll=4,
      cluster_cols=True), 128 -> 256 -> 40: K2;
   C. the protein proxy (132,534 nodes, 79.0M nnz),
      PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
      8 -> 256 -> 112 (OGB's ogbn-proteins GCN widths): K3.
   Counts are set to 0 just before a path serves and read just after:
   its kernel must launch exactly twice per request, every other kernel
   and every plain version never. Logits must match the same forward
   with impl="reference" (rtol=1e-4, atol=1e-4) and a float64 host
   forward (path C: the rows of the first and the last window). The
   path's kernel is held against its plain version at the path's two
   SpMM widths, under the float32 summation bound of its rows.
5. Timing with CUDA events, in turns (plain, kernel, kernel, plain): each
   kernel and its plain version per SpMM at its path's widths, and the
   request on the kernel path and on the plain path; torch.profiler's
   device time by kernel over 3 requests of each path, and the share of
   the profiled wall time the card was busy.

Before the last line come a JSON object describing each kernel and then
nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


def in_turns(torch, kernel, plain, plain_iters=3):
    """(kernel ms, plain ms, the four readings): plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, iters=plain_iters, warmup=1)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain, iters=plain_iters, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def rows_only(a, keep):
    """`a` with every row r for which keep(r) is false emptied."""
    a = a.tolil()
    for r in range(a.shape[0]):
        if not keep(r):
            a.rows[r], a.data[r] = [], []
    return a.tocsr()


def host_forward(a, x0, params, rows=None):
    """Float64 GCN forward on the host (scipy CSR), mean aggregation, the
    same order as gcn_forward for in_dim <= 256. With `rows`, the second
    layer only for those rows."""
    a64 = a.astype(np.float64)
    inv_deg = 1.0 / np.maximum(np.asarray(a64.sum(axis=1)), 1.0)
    h = np.maximum((inv_deg * (a64 @ x0)) @ params["w1"] + params["b1"], 0.0)
    if rows is None:
        return (inv_deg * (a64 @ h)) @ params["w2"] + params["b2"]
    return (inv_deg[rows] * (a64[rows] @ h)) @ params["w2"] + params["b2"]


def profile_requests(torch, fn, requests: int = 3):
    """torch.profiler over `requests` calls of fn(): (kernel name, device
    ms per request), largest first, and the profiled wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the profiler's own start-up
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3  # before the trace is processed
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue  # host-side ops carry their kernels' time too
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key[:70], us / 1e3 / requests))
    rows.sort(key=lambda r: -r[1])
    return rows, wall


def main() -> None:
    import torch

    # --- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from voltrix_spmm_tpu_torch import GCN, PlanConfig, build_graph, calc_diff, csr_preprocess, gcn_params_from_jax
    from voltrix_spmm_tpu_torch.data import chung_lu_csr, erdos_renyi_csr, proxy_csr, symmetrize
    from voltrix_spmm_tpu_torch.format import plan_stats, subtile_stats
    from voltrix_spmm_tpu_torch.jit import get_build_dir
    from voltrix_spmm_tpu_torch.ops import (
        block_spmm, fused_spmm, spmm_block, spmm_fused, spmm_fused_reference,
        spmm_reference, spmm_subtile, spmm_subtile_reference, subtile_spmm,
    )

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

    # name -> (wrapper, plain version, source, TPU kernel it replaces)
    kernels = {
        "spmm_block": (spmm_block, spmm_reference, "spmm_block.cu",
                       "voltrix_spmm_tpu/ops/pallas_spmm.py:165"),
        "spmm_subtile": (spmm_subtile, spmm_subtile_reference, "spmm_subtile.cu",
                         "voltrix_spmm_tpu/ops/pallas_spmm.py:223"),
        "spmm_fused": (spmm_fused, spmm_fused_reference, "spmm_fused.cu",
                       "voltrix_spmm_tpu/ops/pallas_spmm_fused.py:45"),
    }

    # --- 2. build: one nvcc per source, all started together -----------
    def timed_build(module):
        t0 = time.perf_counter()
        module.load_library()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        builds = dict(zip(kernels, pool.map(timed_build, (block_spmm, subtile_spmm, fused_spmm))))
    t_nvcc = time.perf_counter() - t0
    print(f"build: {', '.join(f'{kernels[k][2]} {s:.2f} s' for k, s in builds.items())}; "
          f"{t_nvcc:.2f} s in all, into {get_build_dir()}")

    # --- 3. kernels against their plain versions --------------------------
    max_err = dict.fromkeys(kernels, 0.0)

    def compare(name, label, plan, feat, deg=None):
        """The kernel against its plain version. With `deg` (row degrees)
        the allowance of each row also holds the textbook bound on float32
        summation in any order, (deg - 1) * 2**-24 * sum|x|, once for each
        version: hub rows of a power-law graph sum tens of thousands of
        terms, and the test_spmm tolerance is set for small degrees."""
        kernel, plain = kernels[name][:2]
        out_k = kernel(plan, feat)
        out_p = plain(plan, feat)
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape or not bool(torch.isfinite(out_k).all()):
            fail(f"{name} {label}: kernel output {tuple(out_k.shape)} is not a finite "
                 f"{tuple(out_p.shape)}")
        diff = calc_diff(out_k, out_p)
        err = (out_k - out_p).abs().max().item() if out_k.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        allow = TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * out_p.abs()
        if deg is not None:
            abs_sum = plain(plan, feat.abs())
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        ok = diff < 1e-6 and bool(((out_k - out_p).abs() <= allow).all())
        print(f"  {label}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e} "
              f"-> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version on {label}")

    rng = np.random.default_rng(0)

    def feat_of(n, d):
        return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def case(name, label, a, d, cfg, expect=None, drop_occ=False):
        n = a.shape[0]
        plan = csr_preprocess(a.indptr, a.indices, n, cfg)
        if drop_occ:
            plan = dataclasses.replace(plan, occ=None)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        compare(name, label, plan.to(dev), feat_of(n, d))

    def zero_block(p):
        return bool((p.bitmask.view(p.total_blocks, -1) == 0).all(1).any())

    print(f"kernel K1 against its plain version (calc_diff < 1e-6, allclose {TOL_KERNEL}):")
    k1 = "spmm_block"
    case(k1, "n3000 d300 PlanConfig(128,128), bit 31 set", erdos_renyi_csr(3000, 0.02, 1),
         300, PlanConfig(128, 128), expect=lambda p: bool((p.bitmask < 0).any()))
    case(k1, "n1000 d64 PlanConfig(32,128,block_unroll=4)", erdos_renyi_csr(1000, 0.02, 2),
         64, PlanConfig(32, 128, block_unroll=4))
    case(k1, "n1000 d256 PlanConfig(128,256)", erdos_renyi_csr(1000, 0.01, 3),
         256, PlanConfig(128, 256))
    case(k1, "n700 d72 PlanConfig(48,128) (block_h not a multiple of 32)",
         erdos_renyi_csr(700, 0.02, 4), 72, PlanConfig(48, 128))
    case(k1, "n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 5), lambda r: not 256 <= r < 512),
         96, PlanConfig(128, 128), expect=lambda p: not p.has_empty_windows and zero_block(p))
    case(k1, "n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 6), lambda r: r < 128),
         128, PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
    case(k1, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 7), 64,
         PlanConfig(128, 128), expect=lambda p: p.total_blocks == 0)
    case(k1, "n1001 d40 PlanConfig(128,128,gather_segment=4)", erdos_renyi_csr(1001, 0.01, 8),
         40, PlanConfig(128, 128, gather_segment=4), expect=lambda p: int(p.hind.max()) >= 1001)

    print("kernel K2 against its plain version (clustered plans):")
    k2 = "spmm_subtile"
    community = chung_lu_csr(6000, 60000, community=128, local_frac=0.8, seed=9)
    for h in (128, 256, 512, 2048):
        for u in (1, 4):
            case(k2, f"n6000 d96 PlanConfig({h},128,block_unroll={u},cluster_cols=True)",
                 community, 96, PlanConfig(h, 128, block_unroll=u, cluster_cols=True),
                 expect=lambda p: p.occ is not None)
    case(k2, "n3001 d64 PlanConfig(256,128,gather_segment=2,cluster_cols=True)",
         erdos_renyi_csr(3001, 0.005, 10), 64,
         PlanConfig(256, 128, gather_segment=2, cluster_cols=True))
    case(k2, "n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 11), lambda r: not 256 <= r < 512), 96,
         PlanConfig(128, 128, cluster_cols=True),
         expect=lambda p: not p.has_empty_windows and bool((p.occ == 0).any()))
    case(k2, "n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 12), lambda r: r < 128), 128,
         PlanConfig(128, 128, cluster_cols=True), expect=lambda p: p.has_empty_windows)
    case(k2, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 13), 64,
         PlanConfig(128, 128, cluster_cols=True), expect=lambda p: p.total_blocks == 0)
    case(k2, "n6000 d300 PlanConfig(512,128,block_unroll=4,cluster_cols=True)", community,
         300, PlanConfig(512, 128, block_unroll=4, cluster_cols=True))
    case(k2, "n6000 d72 PlanConfig(2048,128,block_unroll=4,cluster_cols=True), occ None",
         community, 72, PlanConfig(2048, 128, block_unroll=4, cluster_cols=True), drop_occ=True)

    print("kernel K3 against its plain version (coverage plans):")
    k3 = "spmm_fused"
    case(k3, "n512 d64 PlanConfig(128,128,gather_segment=8)", erdos_renyi_csr(512, 0.05, 14),
         64, PlanConfig(128, 128, gather_segment=8))
    case(k3, "n300 d130 PlanConfig(32,128,gather_segment=16)", erdos_renyi_csr(300, 0.02, 15),
         130, PlanConfig(32, 128, gather_segment=16))
    case(k3, "n700 d256 PlanConfig(64,256,gather_segment=32)", erdos_renyi_csr(700, 0.01, 16),
         256, PlanConfig(64, 256, gather_segment=32))
    case(k3, "n5000 d96 PlanConfig(2048,128,gather_segment=128,block_unroll=4), tail past n",
         erdos_renyi_csr(5000, 0.01, 17), 96,
         PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
         expect=lambda p: int(p.hind.max()) >= 5000)
    case(k3, "n2048 d64 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 18), lambda r: not 256 <= r < 512), 64,
         PlanConfig(128, 128, gather_segment=8), expect=lambda p: not p.has_empty_windows)
    case(k3, "n4096 d64 empty windows left without blocks",
         rows_only(erdos_renyi_csr(4096, 0.01, 19), lambda r: r < 32), 64,
         PlanConfig(32, 128, gather_segment=8, block_unroll=2),
         expect=lambda p: p.has_empty_windows)
    case(k3, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 20), 64,
         PlanConfig(128, 128, gather_segment=8), expect=lambda p: p.total_blocks == 0)
    case(k3, "n3000 d8 PlanConfig(2048,128,gather_segment=128,block_unroll=4)",
         erdos_renyi_csr(3000, 0.02, 21), 8,
         PlanConfig(2048, 128, gather_segment=128, block_unroll=4))
    case(k3, "n3000 d300 PlanConfig(256,128,gather_segment=64,block_unroll=2)",
         erdos_renyi_csr(3000, 0.02, 22), 300,
         PlanConfig(256, 128, gather_segment=64, block_unroll=2))

    # --- 4. + 5. the serving paths ---------------------------------------
    def reset_counts():
        for wrapper, plain, *_ in kernels.values():
            wrapper.launches = 0
            plain.calls = 0

    def serve(label, a, cfg, name, widths, host_rows=None):
        """Build the graph, serve REQUESTS requests on kernel `name`, check
        counts and logits, hold the kernel against its plain version at
        the path's widths, and time both in turns."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        stats = plan_stats(g.plan)
        bpw = torch.diff(g.plan.block_ptr)
        extra = ""
        if cfg.cluster_cols:
            extra = f", sub-window occupancy {subtile_stats(g.plan)['occupancy']:.4f}"
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: "
              f"{stats['num_windows']} windows, {stats['total_blocks']} blocks (largest "
              f"window {int(bpw.max())}), fill {stats['fill_ratio']:.5f}, bitmask "
              f"{g.plan.bitmask.numel() * 4 / 2**20:.1f} MiB{extra}; build_graph {t_build:.2f} s, "
              f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        plan_tensors = ("bitmask", "hind", "window_of_block", "block_ptr")
        if not (all(getattr(g.plan, f).is_cuda for f in plan_tensors)
                and g.plan_t is g.plan and g.inv_deg.is_cuda):
            fail(f"path {label}: the plan is not on the card before the first request")

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

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: w.launches for k, (w, *_) in kernels.items()}
        plain_calls = sum(p.calls for _, p, *_ in kernels.values())
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        want = {k: 2 * REQUESTS if k == name else 0 for k in kernels}
        if counts != want or plain_calls != 0:
            fail(f"path {label} launched {counts} (want {want}) and the plain "
                 f"versions {plain_calls} times (want 0)")

        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(g, x, impl="reference")
                torch.cuda.synchronize()
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and torch.allclose(out, ref, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, max|kernel - plain| "
                      f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")
        t0 = time.perf_counter()
        host = host_forward(a, xs[0].cpu().double().numpy(), params_np, host_rows)
        got = logits[0].cpu().double().numpy()
        if host_rows is not None:
            got = got[host_rows]
        host_err = float(np.abs(got - host).max())
        print(f"  request 0 against a float64 host forward ({len(got)} rows, "
              f"{time.perf_counter() - t0:.2f} s): max|diff| {host_err:.3e}")
        if not np.allclose(got, host, **TOL_LOGITS):
            fail(f"path {label} request 0 disagrees with the float64 host forward")

        kernel, plain = kernels[name][:2]
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        per_width = {}
        for d in (in_dim, hidden):
            feat = xs[0] if d == in_dim else feat_of(n, d)
            compare(name, f"path {label} d{d} (float32 summation bound)", g.plan, feat, deg)
            k_ms, p_ms, turns = in_turns(torch, lambda: kernel(g.plan, feat),
                                         lambda: plain(g.plan, feat))
            per_width[d] = (k_ms, p_ms)
            print(f"  SpMM d={d}: {name} {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms")
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (GCN forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            rows, wall = profile_requests(torch, lambda: model(g, x))
        busy = sum(ms for _, ms in rows) * REQUESTS
        print(f"  profile of {REQUESTS} requests: {wall:.3f} ms wall, {busy:.3f} ms of "
              f"kernels (busy share {busy / wall:.3f}); ms per request by kernel:")
        for key, ms in rows[:8]:
            print(f"    {ms:9.4f}  {key}")
        result = {"launches": counts[name], "request_ms": req_ms,
                  "plain_request_ms": plain_req_ms,
                  "ms": sum(k for k, _ in per_width.values()),
                  "plain_ms": sum(p for _, p in per_width.values())}
        for d, (k_ms, p_ms) in per_width.items():
            result[f"ms_d{d}"], result[f"plain_ms_d{d}"] = k_ms, p_ms
        del g
        torch.cuda.empty_cache()
        return result

    t0 = time.perf_counter()
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    print(f"graph: ogbn-arxiv proxy in {time.perf_counter() - t0:.2f} s")
    results = {
        "spmm_block": serve("A (ogbn-arxiv proxy, K1)", arxiv, PlanConfig(128, 128),
                            "spmm_block", (128, 256, 40)),
        "spmm_subtile": serve("B (ogbn-arxiv proxy clustered, K2)", arxiv,
                              PlanConfig(2048, 128, block_unroll=4, cluster_cols=True),
                              "spmm_subtile", (128, 256, 40)),
    }
    del arxiv
    t0 = time.perf_counter()
    protein = symmetrize(proxy_csr("protein", seed=0))
    n = protein.shape[0]
    print(f"graph: protein proxy in {time.perf_counter() - t0:.2f} s")
    last = (n - 1) // 2048 * 2048
    results["spmm_fused"] = serve(
        "C (protein proxy, K3)", protein,
        PlanConfig(2048, 128, gather_segment=128, block_unroll=4), "spmm_fused",
        (8, 256, 112), host_rows=np.r_[0:2048, last:n])

    if "jax" in sys.modules or "voltrix_spmm_tpu" in sys.modules:
        fail("jax or the JAX package was imported")
    print(f"timing on {smi} (CUDA events; kernels mean of 20 launches after 3 warm-up, "
          "plain versions of 3 after 1; in turns plain, kernel, kernel, plain)")
    print(f"total {time.perf_counter() - t_start:.1f} s (nvcc {t_nvcc:.2f} s)")
    line = []
    for name, (_, _, source, replaces) in kernels.items():
        line.append({"name": name, "route": "cuda",
                     "source": f"voltrix_spmm_tpu_torch/csrc/{source}",
                     "replaces": replaces, "max_abs_err": max_err[name], **results[name]})
    # ms / plain_ms: the path's two SpMMs of one request, summed
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()

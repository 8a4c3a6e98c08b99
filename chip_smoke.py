#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voltrix_spmm_tpu_torch) on one
NVIDIA GPU of the Hopper generation (sm_90a, an H100).

    python3 chip_smoke.py

It imports neither jax nor the JAX package. Phases, each of which exits
non-zero on failure (there is no CPU fallback):

1. Device: the card's name and count, and nvidia-smi's name and power
   limit. No CUDA device -> exit 1 before anything else.
2. Build: kernels K1 (csrc/spmm_block.cu), K2 (csrc/spmm_subtile.cu), K3
   (csrc/spmm_fused.cu), K4 (csrc/spmm_weighted.cu) and K5
   (csrc/spmm_dvalues.cu), one nvcc each, all started together, into
   build/kernels/.
3. Each kernel against its plain version on the card, on several plan
   geometries: calc_diff < 1e-6 and allclose(rtol=1e-5, atol=1e-4)
   (float32 sums in another order, so not bit-equal); K5 also exactly 0.0
   off the bitmask.
4. The paths, each driven through the entry points a user calls, with
   every count set to 0 just before and read just after:
   A. GCN serving on the ogbn-arxiv proxy (169,343 nodes),
      PlanConfig(128, 128), 128 -> 256 -> 40: K1 twice per request; then
      GCN training on the same graph, 3 SGD steps: K1 3 times per step.
   B. GCN serving on the same graph, PlanConfig(2048, 128,
      block_unroll=4, cluster_cols=True): K2.
   D. GAT serving and training on the same graph with self-loops
      (2,083,571 nnz), PlanConfig(64, 128), 128 -> 8 heads x 8 (ELU) ->
      40: K4 9 times per request; K4 18 and K5 9 times per Adam step.
   C. GCN serving on the protein proxy (132,534 nodes, 79.0M nnz),
      PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
      8 -> 256 -> 112 (OGB's ogbn-proteins GCN widths): K3.
   Every other kernel and every plain version is launched 0 times. Logits
   must match the same forward with impl="reference" (rtol=1e-4,
   atol=1e-4), and for A-C a float64 host forward (C: the rows of the
   first and the last window). A training step 0's loss and gradients
   must match the plain path's (calc_diff < 1e-6, allclose rtol 1e-4,
   atol 1e-5 x max|grad| for GAT, 1e-3 x max|grad| for GCN, whose ReLU
   may switch on an input within float32 noise of 0); the loss after 3
   steps must be finite, and for GAT below step 0's. Each path's kernels are held against their plain
   versions at the path's widths, under the float32 summation bound of
   their rows.
5. Timing with CUDA events, in turns (plain, kernel, kernel, plain): each
   kernel and its plain version at its path's widths, the one PyTorch
   call that computes the same function (torch.sparse.mm on the CSR for
   K1-K4, torch.sparse.sampled_addmm for K5), the request and the
   training step on the kernel path and on the plain path; each kernel's
   bound (bytes over 3.35 TB/s or float32 flops over 67 TFLOP/s, the
   larger); torch.profiler's device time by kernel, and the share of the
   profiled wall time the card was busy.

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
import scipy.sparse as sp

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:51-52
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
REQUESTS = 3
STEPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory peak rate
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, the larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def csr_tensor(torch, a, dev, values=None):
    """scipy CSR `a` as a torch sparse CSR tensor on `dev` (ones, or
    `values` in CSR order): the operand of the library calls."""
    if not a.has_sorted_indices:
        if values is not None:
            fail("csr_tensor: values of a CSR whose rows are not sorted")
        a = a.sorted_indices()
    vals = torch.ones(a.nnz, dtype=torch.float32) if values is None else values
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)), torch.from_numpy(a.indices.astype(np.int64)),
        vals.float().cpu(), size=a.shape).to(dev)


def grads_close(torch, calc_diff, got: dict, want: dict, atol_scale: float):
    """(ok, worst calc_diff, worst max|diff| / max|grad|) of two gradient
    dicts: calc_diff < 1e-6 and allclose(rtol 1e-4, atol atol_scale *
    max|grad|) for each parameter."""
    ok, worst_diff, worst_rel = True, 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        scale = w.abs().max().item()
        diff = calc_diff(g, w)
        err = (g - w).abs().max().item()
        print(f"    grad {k} {tuple(w.shape)}: calc_diff {diff:.3e}, max|diff| {err:.3e}, "
              f"max|grad| {scale:.3e}")
        worst_diff, worst_rel = max(worst_diff, diff), max(worst_rel, err / max(scale, 1e-30))
        ok = ok and diff < 1e-6 and torch.allclose(g, w, rtol=1e-4, atol=atol_scale * scale)
    return ok, worst_diff, worst_rel


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
    ms per request) and (host op, count, host ms per request), largest
    first, and the profiled wall ms."""
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
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            host.append((e.key[:50], e.count // requests, e.self_cpu_time_total / 1e3 / requests))
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue  # host-side ops carry their kernels' time too
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key[:70], us / 1e3 / requests))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[2])
    return rows, host, wall


def print_profile(rows, host, wall, what, top=10):
    busy = sum(ms for _, ms in rows) * REQUESTS
    print(f"  profile of {REQUESTS} {what}s: {wall:.3f} ms wall, {busy:.3f} ms of kernels (busy "
          f"share {busy / wall:.3f}); device ms per {what} by kernel:")
    for key, ms in rows[:top]:
        print(f"    {ms:9.4f}  {key}")
    print(f"  host ms per {what} by op (self time, calls), {sum(ms for *_, ms in host):.3f} in all:")
    for key, count, ms in host[:5]:
        print(f"    {ms:9.4f}  {key} x{count}")


def main() -> None:
    import torch

    # --- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from voltrix_spmm_tpu_torch import (
        GAT, GCN, PlanConfig, build_gat_graph, build_graph, calc_diff, csr_preprocess,
        gat_loss, gat_params_from_jax, gcn_loss, gcn_params_from_jax, make_train_step,
    )
    from voltrix_spmm_tpu_torch.data import chung_lu_csr, erdos_renyi_csr, proxy_csr, symmetrize
    from voltrix_spmm_tpu_torch.format import plan_stats, subtile_stats
    from voltrix_spmm_tpu_torch.jit import get_build_dir
    from voltrix_spmm_tpu_torch.models import edge_softmax
    from voltrix_spmm_tpu_torch.ops import (
        block_spmm, expand_bitmask, fused_spmm, spmm_block, spmm_fused, spmm_fused_reference,
        spmm_reference, spmm_subtile, spmm_subtile_reference, spmm_weighted,
        spmm_weighted_dvalues, spmm_weighted_dvalues_reference, spmm_weighted_reference,
        subtile_spmm, weighted,
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

    # name -> (wrapper, plain version, source, TPU kernel it replaces, loader)
    kernels = {
        "spmm_block": (spmm_block, spmm_reference, "spmm_block.cu",
                       "voltrix_spmm_tpu/ops/pallas_spmm.py:165", block_spmm.load_library),
        "spmm_subtile": (spmm_subtile, spmm_subtile_reference, "spmm_subtile.cu",
                         "voltrix_spmm_tpu/ops/pallas_spmm.py:223", subtile_spmm.load_library),
        "spmm_fused": (spmm_fused, spmm_fused_reference, "spmm_fused.cu",
                       "voltrix_spmm_tpu/ops/pallas_spmm_fused.py:45", fused_spmm.load_library),
        "spmm_weighted": (spmm_weighted, spmm_weighted_reference, "spmm_weighted.cu",
                          "voltrix_spmm_tpu/ops/weighted.py:29", weighted.load_library),
        "spmm_dvalues": (spmm_weighted_dvalues, spmm_weighted_dvalues_reference,
                         "spmm_dvalues.cu", "voltrix_spmm_tpu/ops/weighted.py:151",
                         weighted.load_dvalues_library),
    }

    # --- 2. build: one nvcc per source, all started together -----------
    def timed_build(loader):
        t0 = time.perf_counter()
        loader()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        builds = dict(zip(kernels, pool.map(timed_build, [k[4] for k in kernels.values()])))
    t_nvcc = time.perf_counter() - t0
    print(f"build: {', '.join(f'{kernels[k][2]} {s:.2f} s' for k, s in builds.items())}; "
          f"{t_nvcc:.2f} s in all, into {get_build_dir()}")

    # --- 3. kernels against their plain versions --------------------------
    max_err = dict.fromkeys(kernels, 0.0)

    def compare(name, label, plan, args, deg=None):
        """The kernel against its plain version on `args` ((feat,), or
        (feat, g) for K5). With `deg` (row degrees) the allowance of each
        row also holds the textbook bound on float32 summation in any
        order, (deg - 1) * 2**-24 * sum|a x|, once for each version: hub
        rows of a power-law graph sum tens of thousands of terms, and the
        test_spmm tolerance is set for small degrees."""
        kernel, plain = kernels[name][:2]
        out_k = kernel(plan, *args)
        out_p = plain(plan, *args)
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape or not bool(torch.isfinite(out_k).all()):
            fail(f"{name} {label}: kernel output {tuple(out_k.shape)} is not a finite "
                 f"{tuple(out_p.shape)}")
        diff = calc_diff(out_k, out_p)
        err = (out_k - out_p).abs().max().item() if out_k.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        allow = TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * out_p.abs()
        if deg is not None:
            abs_sum = plain(plan, args[0].abs())  # K4's values are >= 0 on path D
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        ok = diff < 1e-6 and bool(((out_k - out_p).abs() <= allow).all())
        extra = ""
        if name == "spmm_dvalues" and out_k.numel():
            off = ~expand_bitmask(plan.bitmask, plan.config.block_h, torch.bool)
            zero = bool((out_k[off] == 0).all())
            ok = ok and zero
            extra = f", off the bitmask {'all 0.0' if zero else 'NOT ZERO'}"
        print(f"  {label}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e}{extra} "
              f"-> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version on {label}")

    rng = np.random.default_rng(0)

    def feat_of(n, d):
        return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def case(name, label, a, d, cfg, expect=None, drop_occ=False, off_mask=False):
        n = a.shape[0]
        weighted_kernel = name in ("spmm_weighted", "spmm_dvalues")
        values = rng.standard_normal(a.nnz).astype(np.float32) if weighted_kernel else None
        plan = csr_preprocess(a.indptr, a.indices, n, cfg, values=values)
        if drop_occ:
            plan = dataclasses.replace(plan, occ=None)
        if off_mask:  # values in every slot, off the bitmask too: K4 reads them all
            dense = rng.standard_normal(tuple(plan.values.shape)).astype(np.float32)
            plan = dataclasses.replace(plan, values=torch.from_numpy(dense))
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        args = (feat_of(n, d),) if name != "spmm_dvalues" else (feat_of(n, d), feat_of(n, d))
        compare(name, label, plan.to(dev), args)

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

    hub = symmetrize(chung_lu_csr(8000, 80000, seed=23))  # hub windows span many K4 tasks
    for name, kid in (("spmm_weighted", "K4"), ("spmm_dvalues", "K5")):
        print(f"kernel {kid} against its plain version (weighted plans):")
        case(name, "n3000 d8 PlanConfig(64,128)", erdos_renyi_csr(3000, 0.01, 24), 8,
             PlanConfig(64, 128))
        case(name, "n3000 d40 PlanConfig(64,128,block_unroll=2)", erdos_renyi_csr(3000, 0.01, 25),
             40, PlanConfig(64, 128, block_unroll=2))
        case(name, "n1000 d100 PlanConfig(32,128) (unaligned D)", erdos_renyi_csr(1000, 0.02, 26),
             100, PlanConfig(32, 128))
        case(name, "n1000 d300 PlanConfig(128,128)", erdos_renyi_csr(1000, 0.02, 27), 300,
             PlanConfig(128, 128))
        case(name, "n700 d64 PlanConfig(32,256)", erdos_renyi_csr(700, 0.02, 28), 64,
             PlanConfig(32, 256))
        case(name, "n1500 d40 PlanConfig(96,128) (rows per thread not a power of two)",
             erdos_renyi_csr(1500, 0.01, 33), 40, PlanConfig(96, 128))
        case(name, "n8000 d40 PlanConfig(64,128), power-law hub windows", hub, 40,
             PlanConfig(64, 128), expect=lambda p: int(torch.diff(p.block_ptr).max()) > 16)
        case(name, "n2048 d24 empty windows padded with zero-bit blocks",
             rows_only(erdos_renyi_csr(2048, 0.01, 29), lambda r: not 256 <= r < 512), 24,
             PlanConfig(128, 128), expect=lambda p: not p.has_empty_windows and zero_block(p))
        case(name, "n10240 d8 empty windows left without blocks",
             rows_only(erdos_renyi_csr(10240, 0.002, 30), lambda r: r < 64), 8,
             PlanConfig(64, 128), expect=lambda p: p.has_empty_windows)
        case(name, "n500 d8 empty matrix", erdos_renyi_csr(500, 0.0, 31), 8,
             PlanConfig(64, 128), expect=lambda p: p.total_blocks == 0)
        case(name, "n2000 d40 PlanConfig(64,128), values off the bitmask",
             erdos_renyi_csr(2000, 0.01, 32), 40, PlanConfig(64, 128), off_mask=True)

    # --- 4. + 5. the paths ------------------------------------------------
    def reset_counts():
        for wrapper, plain, *_ in kernels.values():
            wrapper.launches = 0
            plain.calls = 0

    def read_counts():
        return ({k: w.launches for k, (w, *_) in kernels.items()},
                sum(p.calls for _, p, *_ in kernels.values()))

    def check_counts(label, counts, plain_calls, want_nonzero):
        want = {k: want_nonzero.get(k, 0) for k in kernels}
        if counts != want or plain_calls != 0:
            fail(f"path {label} launched {counts} (want {want}) and the plain "
                 f"versions {plain_calls} times (want 0)")

    def library_ms(fn):
        return cuda_ms(torch, fn, iters=10, warmup=2)

    def train(label, loss_fn, model, g, x, y, optimizer, want_launches, atol_scale):
        """STEPS steps of make_train_step(optimizer, loss_fn) on the kernel
        path, counted; step 0's loss and gradients against the plain path
        from the same parameters (see grads_close for atol_scale). Returns
        (losses, launch counts, final loss, peak GiB)."""
        params = model.params()
        pref = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss_ref = loss_fn(pref, g, x, y, impl="reference")
        want = dict(zip(pref, torch.autograd.grad(loss_ref, list(pref.values()))))
        step = make_train_step(optimizer, loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, ms, grads0 = [], [], None
        for i in range(STEPS):
            t0 = time.perf_counter()
            losses.append(step(params, g, x, y))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                grads0 = {k: v.grad.detach().clone() for k, v in params.items()}
        counts, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  trained {STEPS} steps: launches {counts}, plain calls {plain_calls}; host ms "
              f"per step {[round(t, 3) for t in ms]}; losses {[round(l.item(), 6) for l in losses]};"
              f" torch.cuda.max_memory_allocated {peak:.3f} GiB")
        check_counts(label, counts, plain_calls, {k: STEPS * n for k, n in want_launches.items()})
        ok, diff, rel = grads_close(torch, calc_diff, grads0, want, atol_scale)
        loss_ok = torch.allclose(losses[0], loss_ref.detach(), rtol=1e-4, atol=0.0)
        print(f"  step 0 against the plain path: loss {losses[0].item():.6f} / "
              f"{loss_ref.item():.6f}, gradients worst calc_diff {diff:.3e}, worst "
              f"max|diff|/max|grad| {rel:.3e} -> {'ok' if ok and loss_ok else 'MISMATCH'}")
        if not (ok and loss_ok):
            fail(f"path {label}: step 0 disagrees with the plain path")
        with torch.no_grad():
            final = loss_fn(params, g, x, y)
        if not bool(torch.isfinite(final)):
            fail(f"path {label}: the loss after {STEPS} steps is not finite")
        print(f"  loss after {STEPS} steps {final.item():.6f} (step 0: {losses[0].item():.6f})")
        return losses, counts, final, peak

    def time_steps(label, loss_fn, model, g, x, y, optimizer):
        step = make_train_step(optimizer, loss_fn)
        params = model.params()
        k_ms, p_ms, turns = in_turns(torch, lambda: step(params, g, x, y),
                                     lambda: step(params, g, x, y, impl="reference"),
                                     plain_iters=2)
        print(f"  training step: kernel path {k_ms:.4f} ms ({turns[1]:.4f} / {turns[2]:.4f}), "
              f"plain path {p_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        print_profile(*profile_requests(torch, lambda: step(params, g, x, y)), "training step")
        return k_ms, p_ms

    def serve(label, a, cfg, name, widths, host_rows=None, train_gcn=False):
        """Build the graph, serve REQUESTS requests on kernel `name`, check
        counts and logits, hold the kernel against its plain version at
        the path's widths, time both and the library call in turns, and
        (train_gcn) train the GCN on the same graph."""
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
        counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {name: 2 * REQUESTS})

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
        csr = csr_tensor(torch, a, dev)
        plan_fields = [g.plan.bitmask, g.plan.hind, g.plan.block_ptr, g.plan.occ]
        per_width = {}
        for d in (in_dim, hidden):
            feat = xs[0] if d == in_dim else feat_of(n, d)
            compare(name, f"path {label} d{d} (float32 summation bound)", g.plan, (feat,), deg)
            k_ms, p_ms, turns = in_turns(torch, lambda: kernel(g.plan, feat),
                                         lambda: plain(g.plan, feat))
            lib = library_ms(lambda: torch.sparse.mm(csr, feat))
            b_ms, b_by = bound_ms(tensor_bytes(*plan_fields) + 2 * n * d * 4, 2 * a.nnz * d)
            per_width[d] = (k_ms, p_ms, lib, b_ms, b_by)
            print(f"  SpMM d={d}: {name} {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (GCN forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request", top=8)
        result = {"launches": counts[name], "request_ms": req_ms,
                  "plain_request_ms": plain_req_ms}
        result.update(widths_summary(per_width))

        if train_gcn:
            print(f"path {label}, training: GCN {in_dim} -> {hidden} -> {classes}, "
                  f"{STEPS} SGD steps (lr 0.1) on labels from the seed")
            tmodel = GCN.from_params(gcn_params_from_jax(params_np, dev))
            y = torch.from_numpy(np.random.default_rng(3).integers(0, classes, n)).to(dev)
            # atol 1e-3 x max|grad|: a ReLU input within float32 noise of 0
            # may switch between the two paths, moving one node's share of
            # a gradient (1.1e-4 of max|grad_b1| in one run of this script)
            _, _, _, peak = train(
                f"{label} training", gcn_loss, tmodel, g, xs[0], y,
                torch.optim.SGD(tmodel.parameters(), lr=0.1), {name: 3}, atol_scale=1e-3)
            step_ms, plain_step_ms = time_steps(
                label, gcn_loss, tmodel, g, xs[0], y, torch.optim.SGD(tmodel.parameters(), lr=0.1))
            result.update(train_launches=STEPS * 3, train_step_ms=step_ms,
                          plain_train_step_ms=plain_step_ms, train_peak_gib=peak)
        del g, csr
        torch.cuda.empty_cache()
        return result

    def widths_summary(per_width):
        """ms, plain_ms, library_ms and bound_ms: one call at each of the
        path's widths, summed; and each width's numbers."""
        result = {"ms": sum(v[0] for v in per_width.values()),
                  "plain_ms": sum(v[1] for v in per_width.values()),
                  "library_ms": sum(v[2] for v in per_width.values()),
                  "bound_ms": sum(v[3] for v in per_width.values())}
        widest = max(per_width.values(), key=lambda v: v[3])
        result["bound_by"] = widest[4]
        for d, (k_ms, p_ms, lib, b_ms, _) in per_width.items():
            result[f"ms_d{d}"], result[f"plain_ms_d{d}"] = k_ms, p_ms
            result[f"library_ms_d{d}"], result[f"bound_ms_d{d}"] = lib, b_ms
        return result

    def gat_path(label, a, cfg, widths, heads):
        """Path D: GAT serving (K4) and training (K4 and K5) on `a`."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_gat_graph(a.indptr, a.indices, n, cfg, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        stats, stats_t = plan_stats(g.plan), plan_stats(g.plan_t)
        bpw = torch.diff(g.plan.block_ptr)
        plane_mib = stats["expanded_slots"] * 4 / 2**20
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: {stats['num_windows']} "
              f"windows, {stats['total_blocks']} blocks for A and {stats_t['total_blocks']} for "
              f"A^T (largest window {int(bpw.max())}, mean {float(bpw.float().mean()):.2f}), "
              f"value plane {plane_mib:.1f} MiB, largest slot {int(g.slots.max())}; "
              f"build_gat_graph {t_build:.2f} s, host peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        if not (g.plan.hind.is_cuda and g.plan_t.bitmask.is_cuda and g.slots.is_cuda):
            fail(f"path {label}: the graph is not on the card before the first request")

        prng = np.random.default_rng(2)  # init_gat's layouts and scales
        params_np = {
            "w1": prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
            "a1_src": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
            "a1_dst": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
            "w2": prng.standard_normal((heads * hidden, classes)) * (2.0 / (heads * hidden)) ** 0.5,
            "a2_src": prng.standard_normal(classes) * classes ** -0.5,
            "a2_dst": prng.standard_normal(classes) * classes ** -0.5,
        }
        model = GAT.from_params(gat_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        per_request = heads + 1

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {"spmm_weighted": per_request * REQUESTS})
        serve_launches = counts["spmm_weighted"]
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

        # the kernels at the path's widths, on head 0's attention plane
        with torch.no_grad():
            h0 = (xs[0] @ model.w1[0]).contiguous()
            e = torch.nn.functional.leaky_relu(
                (h0 @ model.a1_src[0])[g.rows] + (h0 @ model.a1_dst[0])[g.cols], 0.2)
            alpha = edge_softmax(g, e)
            tb, H, K = g.plan.total_blocks, cfg.block_h, cfg.block_w
            plane = torch.zeros(tb * H * K, device=dev).index_add_(0, g.slots, alpha)
            wplan = dataclasses.replace(g.plan, values=plane.view(tb, H, K))
        nz = int(torch.count_nonzero(wplan.values))
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr_w = csr_tensor(torch, a, dev, alpha)
        csr_1 = csr_tensor(torch, a, dev)
        k4, k5 = kernels["spmm_weighted"][:2], kernels["spmm_dvalues"][:2]
        per_width = {"spmm_weighted": {}, "spmm_dvalues": {}}
        for d in (hidden, classes):
            feat = h0 if d == hidden else feat_of(n, d)
            grad = feat_of(n, d)
            compare("spmm_weighted", f"path {label} K4 d{d} (float32 summation bound)",
                    wplan, (feat,), deg)
            compare("spmm_dvalues", f"path {label} K5 d{d}", wplan, (feat, grad))
            k_ms, p_ms, turns = in_turns(torch, lambda: k4[0](wplan, feat),
                                         lambda: k4[1](wplan, feat))
            lib = library_ms(lambda: torch.sparse.mm(csr_w, feat))
            b_ms, b_by = bound_ms(
                tensor_bytes(wplan.values, wplan.hind, wplan.window_of_block) + 2 * n * d * 4,
                2 * nz * d)
            per_width["spmm_weighted"][d] = (k_ms, p_ms, lib, b_ms, b_by)
            print(f"  K4 d={d}: spmm_weighted {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})")
            k_ms, p_ms, turns = in_turns(torch, lambda: k5[0](wplan, feat, grad),
                                         lambda: k5[1](wplan, feat, grad))
            feat_t = feat.t().contiguous()
            lib = library_ms(lambda: torch.sparse.sampled_addmm(csr_1, grad, feat_t, beta=0.0))
            # reads the plan's geometry, feat and g; writes the (tb, H, K) plane
            b_ms, b_by = bound_ms(
                tensor_bytes(wplan.bitmask, wplan.hind, wplan.window_of_block)
                + 2 * n * d * 4 + tb * H * K * 4, 2 * a.nnz * d)
            per_width["spmm_dvalues"][d] = (k_ms, p_ms, lib, b_ms, b_by)
            print(f"  K5 d={d}: spmm_dvalues {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.sampled_addmm {lib:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
        del wplan, plane, csr_w, csr_1
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (GAT forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat.py:57) "
              "on labels from the seed")
        tmodel = GAT.from_params(gat_params_from_jax(params_np, dev))
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
        losses, train_counts, final, peak = train(
            f"{label} training", gat_loss, tmodel, g, xs[0], y,
            torch.optim.Adam(tmodel.parameters(), lr=5e-3),
            {"spmm_weighted": 2 * per_request, "spmm_dvalues": per_request}, atol_scale=1e-5)
        if not final.item() < losses[0].item():
            fail(f"path {label}: the loss after {STEPS} steps ({final.item():.6f}) is not "
                 f"below step 0's ({losses[0].item():.6f})")
        step_ms, plain_step_ms = time_steps(
            label, gat_loss, tmodel, g, xs[0], y, torch.optim.Adam(tmodel.parameters(), lr=5e-3))
        results_k4 = {"launches": serve_launches, "train_launches": train_counts["spmm_weighted"],
                      "request_ms": req_ms, "plain_request_ms": plain_req_ms,
                      "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                      "train_peak_gib": peak, **widths_summary(per_width["spmm_weighted"])}
        results_k5 = {"launches": train_counts["spmm_dvalues"], "serve_launches": 0,
                      "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                      **widths_summary(per_width["spmm_dvalues"])}
        del g
        torch.cuda.empty_cache()
        return results_k4, results_k5

    t0 = time.perf_counter()
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    print(f"graph: ogbn-arxiv proxy in {time.perf_counter() - t0:.2f} s")
    results = {
        "spmm_block": serve("A (ogbn-arxiv proxy, K1)", arxiv, PlanConfig(128, 128),
                            "spmm_block", (128, 256, 40), train_gcn=True),
        "spmm_subtile": serve("B (ogbn-arxiv proxy clustered, K2)", arxiv,
                              PlanConfig(2048, 128, block_unroll=4, cluster_cols=True),
                              "spmm_subtile", (128, 256, 40)),
    }
    # self-loops, the GAT convention (examples/train_gat.py:46-47)
    loops = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    loops.sort_indices()
    del arxiv
    results["spmm_weighted"], results["spmm_dvalues"] = gat_path(
        "D (ogbn-arxiv proxy with self-loops, GAT, K4 and K5)", loops, PlanConfig(64, 128),
        (128, 8, 40), heads=8)
    del loops
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
          "plain versions of 3 after 1, library calls of 10 after 2; in turns plain, kernel, "
          "kernel, plain); bounds at 3.35 TB/s and 67 TFLOP/s float32")
    print(f"total {time.perf_counter() - t_start:.1f} s (nvcc {t_nvcc:.2f} s)")
    line = []
    for name, (_, _, source, replaces, _) in kernels.items():
        line.append({"name": name, "route": "cuda",
                     "source": f"voltrix_spmm_tpu_torch/csrc/{source}",
                     "replaces": replaces, "max_abs_err": max_err[name], **results[name]})
    # ms / plain_ms / library_ms / bound_ms: one call at each of the path's two widths, summed
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()

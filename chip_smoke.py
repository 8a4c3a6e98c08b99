#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voltrix_spmm_tpu_torch) on one
NVIDIA GPU of the Hopper generation (sm_90a, an H100).

    python3 chip_smoke.py

It imports neither jax nor the JAX package. Phases, each of which exits
non-zero on failure (there is no CPU fallback):

1. Device: the card's name and count, and nvidia-smi's name and power
   limit. No CUDA device -> exit 1 before anything else.
2. Build: kernels K1 (csrc/spmm_block.cu), K2 (csrc/spmm_subtile.cu), K3
   (csrc/spmm_fused.cu), K4 (csrc/spmm_weighted.cu), K5
   (csrc/spmm_dvalues.cu), K6 (csrc/spmm_ell.cu), K7
   (csrc/spmm_ell_dvals.cu), K14 (csrc/attn_mh_dq.cu), K15
   (csrc/attn_mh_dkv.cu), K9 and K13 (csrc/attn_fwd.cu), K10
   (csrc/attn_bwd.cu) and K8 (csrc/spmm_int8.cu), one nvcc each, all
   started together, into build/kernels/. K11 and K12 are the kernels of
   K14 and K15 launched with one head and float32 planes. The SASS of K5
   and of K9 and K13 holds no atomic instruction (tools/sass_atomics.py).
3. Each kernel against its plain version on the card, on several plan
   geometries: calc_diff < 1e-6 and allclose(rtol=1e-5, atol=1e-4)
   (float32 sums in another order, so not bit-equal); K1 and K2 also on a
   power-law graph whose hub window is cut into >= 16 pieces, a window of
   exactly 2 x PIECE_BLOCKS blocks, d 130 (4-byte copies) and features 4
   bytes past a 16-byte boundary (the hub rows under the float32
   summation bound of their degrees); K4 also on its work list (a
   power-law hub window cut into >= 16 pieces, a window of exactly 2 x
   PIECE_BLOCKS["spmm_weighted"] blocks, d 130, values off the bitmask on
   cut windows; values and features from a generator of their own); K5
   also exactly 0.0 off the bitmask, and on its work list twice on one
   input, bit-identical (block_w 256, bits on rows at num_nodes and beyond,
   0.0 there, hind outside the source rows, hub windows cut into pieces,
   two 128-row groups, three words a group, d 8-100 and 13, empty windows;
   features and dO from a generator of their own); K7 exactly 0.0 on
   padding lanes; K3
   also on its work list and both its walks (a power-law hub window cut
   into >= 16 pieces on J.2's geometry PlanConfig(128, 128, 8) at d 128 and
   256, d 8, 130 and 300, features 4 bytes past a 16-byte boundary, a tail
   run past n at d 8 and 256, empty windows of both kinds at d 8 and 256,
   runs across the 128-lane tiles on PlanConfig(128, 384) at seg 12-192;
   features from a generator of their own), K7 also at d 256 and 300 on
   its wide kernel, on misaligned features at d 256 and on power-law hub
   windows with padding lanes cut into pieces (from a generator of their
   own). K13-K15 (out, lse, dq, dk, dv) with float32 and bf16 planes:
   calc_diff < 1e-6 and allclose(rtol=1e-4, atol=1e-5 x max|plain|); rows
   without edges exactly 0 with lse exactly 1e30; K13 twice on each
   input, bit-identical. K9-K12 (out, lse, K10's dq and lane
   planes, K10 with its fixed-order sum against the plain backward and
   scatter_lanes, dq, dk, dv) on head 0 of the same problems, to the same
   tolerance; K10's lane planes exactly 0 on lanes without bits. K9 and K10
   also on their work list (from a generator of their own): a power-law
   hub window cut into >= 16 pieces at d 8, 12 and 40 and at d 40 with
   rows 4 bytes past a 16-byte boundary, a tail window past n at d 12
   likewise, empty windows of both kinds at d 40; and twice on each of
   these inputs, bit-identical (out, lse, dq, summed dk and dv). K8
   (int8 rows, bf16 dequantization) on 15 geometries under the same
   tolerance: its plain version dequantizes the same int8 rows the same
   way, so only the order of the float32 sums differs; K8 also on K1's
   cases (a power-law hub window cut into >= 16 pieces, a window of
   exactly 2 x PIECE_BLOCKS["spmm_int8"] blocks, d 130: int8 rows of 132
   bytes), the hub rows under the float32 summation bound, on features
   of a generator of their own.
4. The paths, each driven through the entry points a user calls, with
   every count set to 0 just before and read just after:
   A. GCN serving on the ogbn-arxiv proxy (169,343 nodes),
      PlanConfig(128, 128), 128 -> 256 -> 40: K1 twice per request; then
      GCN training on the same graph, 3 SGD steps: K1 3 times per step.
      K1 runs twice on the same input at d 128 and must give the same bits.
      A, B, F, J.1 and J.2 print what K1's or K2's work list gives their
      plans, I and C K8's: pieces, windows cut, the heaviest piece's work
      against the mean, the workspace.
   I. On A's plan, 3 requests of spmm(plan, x, impl="int8") at d 128 and 3
      at d 256: K8 once each; its output against a float64 host product of
      the same bf16-dequantized features (the first and last 2,048 rows)
      and against K1's float32 output (relative error < 2e-2,
      tests/test_quant.py:41). K8 also runs at d 256 on path C's plan;
      on A's plan (d 128) and on C's, K8 runs twice on the same input and
      must give the same bits.
   J. On A's graph: (1) build_graph(..., stream_chunks=4) with A's GCN: 3
      requests (K1 2 x 4 each) whose logits equal path A's bit for bit,
      step-0 loss and gradients equal to the unstreamed graph's, 3 SGD
      steps (K1 3 x 4 each); (2) csr_preprocess_hybrid with the JAX
      package's defaults: 3 spmm requests at d 128 and 3 at d 256 (K3 and
      K1 once each) against K1 on A's plan and the plain path, a
      torch.profiler breakdown at d 128, and spmm_ad's gradient against
      the plain path; K3 alone on the dense side against its plain
      version, twice on one input (the same bits), timed beside
      torch.sparse.mm on the dense side's CSR, with its bound and work
      list.
   B. GCN serving on the same graph, PlanConfig(2048, 128,
      block_unroll=4, cluster_cols=True): K2, which also runs twice on the
      same input at d 128 and must give the same bits.
   D. GAT serving and training on the same graph with self-loops
      (2,083,571 nnz), PlanConfig(64, 128), 128 -> 8 heads x 8 (ELU) ->
      40: K4 9 times per request; K4 18 and K5 9 times per Adam step. It
      prints the set-up cost of the edges' orders (edge_orders), K4's work
      list (pieces, windows cut, workspace) and the layer-2 scores within
      rounding of leaky_relu's kink and the edges whose sign differs
      between the kernel and the plain path. K4 runs twice on the same
      input at d 8 and d 40, and on A^T's plan at d 40, and must give the
      same bits, and so must K5 at d 8 and 40; so must step 0's kernel-path
      gradients, taken twice. K5's work list is printed.
   E. Dot-product GAT serving and training on D's graph, ELL plans
      PlanConfig(128, 128, block_unroll=4), 128 -> 8 heads x 8 (ELU) ->
      40: K6 and K7 9 times per request; K6 36 and K7 18 times per Adam
      step. It prints the scores within rounding of leaky_relu's kink in
      both layers and the edges whose sign differs between the kernel and
      the plain path. K6 runs twice on the same input at d 8 and d 40
      (and on F's plan at d 256) and must give the same bits, and so must
      K6 on 4 window chunks of the plan (spmm_ell_streamed); K7 likewise
      at d 8 and 40 (and on F's plan at d 256, its wide kernel).
   F. GCN link prediction on the ogbl-ddi proxy (4,267 nodes, 2,571,386
      nnz), GCN 256 -> 256 -> 256 on PlanConfig(128, 128) (K1), SDDMM
      scores over the edges and as many sampled non-edges (ELL plan,
      PlanConfig(128, 128)): K1 2 and K7 1 per scoring request; K1 3, K7 1
      and K6 2 per Adam step. K1 is also held to its plain version and
      timed at d 256 on F's plan.
   G. Flash GAT serving and training on D's graph, PlanConfig(128, 128,
      block_unroll=4), 128 -> 8 heads x 8 (ELU) -> 40, bf16 planes (the
      JAX package's rule at >= 65,536 nodes): K13 twice per request; K13,
      K14 and K15 twice each per Adam step. With bf16 planes float32 noise
      may move a layer-2 input across a bf16 rounding boundary, so logits
      and step-0 gradients are held to the bf16 class (calc_diff < 1e-4,
      rtol and atol 2e-2, gradients 1e-2 x max|grad|); the same model
      with float32 planes is held to rtol and atol 1e-4 (gradients 1e-4 x
      max|grad|: a hub row's dq sums ~38k terms whose coefficients add up
      to 0; the gradients also vary in their last bits from run to run,
      as K14's and K15's cut-window flushes add with float atomics).
      Request 0's logits twice, bit-identical. At each layer, on the
      node-major projections the model passes: K13's work list (pieces,
      windows cut, the heaviest piece against the mean, workspace), K13
      twice on one input, bit-identical, and K13 timed in turns beside
      head-major copies of q, k and v made in the call and K13 on those.
   H. Flash GAT on a bare plan, G's graph, plan geometry and widths, one
      head at a time in float32 (the JAX package's per-head path): K9 9
      times per request; K9 and K10 9 times each per Adam step (K10's lane
      planes summed into source rows in a fixed order inside K10, no
      index_add_); logits and step-0 gradients against the plain path to
      rtol / atol 1e-4 (gradients 1e-4 x max|grad|, G's float32 rule), and
      step 0's kernel-path gradients twice, bit-identical; K9 (out, lse)
      and K10 (dq, summed dk and dv) twice on one input at d 8 and 40,
      bit-identical; K9 timed in turns beside K13 at one head (float32
      planes), K10 beside K11 + K12, and scatter_lanes (index_add_) on
      K10's planes. Then the split backward,
      spmm_attention_ad(plan, q, k, v, plan_t=plan) at a layer-1 head (d 8)
      and at layer 2 (d 40): K9, K11 and K12 once each per width, its
      gradients against the plain ones and against K10's.
   C. GCN serving on the protein proxy (132,534 nodes, 79.0M nnz),
      PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
      8 -> 256 -> 112 (OGB's ogbn-proteins GCN widths): K3, which runs
      twice on the same input at d 8 and at d 256 and must give the same
      bits; its work list and workspace are printed.
   Every other kernel and every plain version is launched 0 times. Logits
   must match the same forward with impl="reference" (rtol=1e-4,
   atol=1e-4), and for A-C a float64 host forward (C: the rows of the
   first and the last window); F's scores must match the plain path's
   (calc_diff < 1e-6, allclose rtol 1e-4, atol 1e-4 x max|score|) and so
   must their AUC. A training step 0's loss and gradients must match the
   plain path's (calc_diff < 1e-6, allclose rtol 1e-4, atol 1e-5 x
   max|grad| for GAT, 5e-5 x max|grad| on D, where the plain path's own
   gradients differed from run to run by up to 1.5e-5 x max|grad| while
   both paths summed with float atomics
   (voltrix_spmm_tpu_torch/tools/grad_spread.py), 1e-3 x max|grad| for
   GCN, whose ReLU may switch on an input within float32 noise of 0); the
   loss after 3 steps must be
   finite, and for D, E, F and G below step 0's. Each path's kernels are
   held against their plain versions at the path's widths, under the
   float32 summation bound of their rows.
5. Timing with CUDA events, in turns (plain, kernel, kernel, plain): each
   kernel and its plain version at its path's widths, the one PyTorch
   call that computes the same function (torch.sparse.mm on the CSR for
   K1-K4 and K6, and for K8 on the dequantized features, dequantized
   outside the timed call; torch.sparse.sampled_addmm for K5 and K7; none for
   K9-K15, as no single call computes masked-softmax attention over a
   sparse pattern), the request and the training step on the kernel path
   and on the plain path; each kernel's
   bound (bytes over 3.35 TB/s or float32 flops over 67 TFLOP/s, the
   larger); torch.profiler's device time by kernel, and the share of the
   profiled wall time the card was busy.

Before the last line come a JSON object describing each kernel and then
nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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


def plan_csr(plan):
    """The binary CSR (num_nodes x source_rows, scipy) of a plan's bits:
    row w * block_h + 32 * word + bit, column hind of the bit's lane."""
    import torch

    shifts = torch.arange(32, dtype=torch.int32, device=plan.bitmask.device)
    b, wi, j, bit = torch.nonzero((plan.bitmask.unsqueeze(-1) >> shifts) & 1, as_tuple=True)
    rows = plan.window_of_block[b].long() * plan.config.block_h + 32 * wi + bit
    cols = plan.hind[b, j].long()
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows.cpu().numpy(), cols.cpu().numpy())),
                      shape=(plan.num_nodes, plan.source_rows))
    a.sum_duplicates()
    return a


def grads_close(torch, calc_diff, got: dict, want: dict, atol_scale: float,
                max_diff: float = 1e-6, rtol: float = 1e-4):
    """(ok, worst calc_diff, worst max|diff| / max|grad|) of two gradient
    dicts: calc_diff < max_diff and allclose(rtol, atol atol_scale *
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
        ok = ok and diff < max_diff and torch.allclose(g, w, rtol=rtol, atol=atol_scale * scale)
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
    import torch.nn.functional as F

    from voltrix_spmm_tpu_torch import (
        GAT, GCN, GATDot, GATFlash, PlanConfig, build_ell_graph, build_gat_graph, build_graph,
        build_link_candidates, calc_diff, csr_preprocess, csr_preprocess_ell,
        csr_preprocess_hybrid, dequantize_rows, gat_dot_loss, gat_dot_params_from_jax,
        gat_flash_loss, gat_flash_params_from_jax, gat_loss, gat_params_from_jax, gcn_loss,
        gcn_params_from_jax, hybrid_stats, lane_values, link_auc, link_pred_loss, link_scores,
        make_link_pred_step, make_train_step, relative_error, spmm, spmm_ad,
    )
    from voltrix_spmm_tpu_torch.data import chung_lu_csr, erdos_renyi_csr, proxy_csr, symmetrize
    from voltrix_spmm_tpu_torch.format import ell_stats, plan_stats, subtile_stats
    from voltrix_spmm_tpu_torch.jit import get_build_dir
    from voltrix_spmm_tpu_torch.tools import sass_atomics
    from voltrix_spmm_tpu_torch.models import edge_softmax, gat_attention_aggregate
    from voltrix_spmm_tpu_torch.models.gat import edge_orders
    from voltrix_spmm_tpu_torch.models.gat_ell import dot_attention_aggregate
    from voltrix_spmm_tpu_torch.models.gat_flash import _project_heads
    from voltrix_spmm_tpu_torch.ops import (
        attention, attention_bwd, attention_bwd_reference, attention_bwd_summed, attention_dkv,
        attention_dkv_reference, attention_dq, attention_dq_reference, attention_mh,
        attention_mh_dkv, attention_mh_dkv_reference, attention_mh_dq, attention_mh_dq_reference,
        block_spmm, ell, expand_bitmask, fused_spmm, scatter_lanes, sddmm_ell, sddmm_ell_ad,
        spmm_attention,
        spmm_attention_ad, spmm_attention_mh, spmm_attention_mh_reference,
        spmm_attention_reference, spmm_block, spmm_ell,
        spmm_ell_dvals, spmm_ell_dvals_reference, spmm_ell_reference, spmm_ell_streamed,
        spmm_fused,
        spmm_fused_reference, spmm_reference, spmm_subtile, spmm_subtile_reference,
        spmm_weighted, spmm_weighted_dvalues, spmm_weighted_dvalues_reference,
        spmm_weighted_reference, subtile_spmm, weighted, quant, spmm_int8, spmm_int8_reference,
    )
    from voltrix_spmm_tpu_torch.utils import gen_outlier_normal

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
        "spmm_ell": (spmm_ell, spmm_ell_reference, "spmm_ell.cu",
                     "voltrix_spmm_tpu/ops/ell.py:35", ell.load_library),
        "spmm_ell_dvals": (spmm_ell_dvals, spmm_ell_dvals_reference, "spmm_ell_dvals.cu",
                           "voltrix_spmm_tpu/ops/ell.py:190", ell.load_dvals_library),
        # K13: beside K9 in attn_fwd.cu, on K9's row walk with a head group
        "attn_mh_fwd": (spmm_attention_mh, spmm_attention_mh_reference, "attn_fwd.cu",
                        "voltrix_spmm_tpu/ops/attention_mh.py:126",
                        attention.load_mh_fwd_library),
        "attn_mh_dq": (attention_mh_dq, attention_mh_dq_reference, "attn_mh_dq.cu",
                       "voltrix_spmm_tpu/ops/attention_mh.py:411",
                       attention_mh.load_dq_library),
        "attn_mh_dkv": (attention_mh_dkv, attention_mh_dkv_reference, "attn_mh_dkv.cu",
                        "voltrix_spmm_tpu/ops/attention_mh.py:499",
                        attention_mh.load_dkv_library),
        "attn_fwd": (spmm_attention, spmm_attention_reference, "attn_fwd.cu",
                     "voltrix_spmm_tpu/ops/attention.py:75", attention.load_fwd_library),
        # K11 and K12: K14's and K15's kernels at H = 1
        "attn_bwd": (attention_bwd, attention_bwd_reference, "attn_bwd.cu",
                     "voltrix_spmm_tpu/ops/attention.py:344", attention.load_bwd_library),
        "attn_dq": (attention_dq, attention_dq_reference, "attn_mh_dq.cu",
                    "voltrix_spmm_tpu/ops/attention.py:430", attention_mh.load_dq_library),
        "attn_dkv": (attention_dkv, attention_dkv_reference, "attn_mh_dkv.cu",
                     "voltrix_spmm_tpu/ops/attention.py:494", attention_mh.load_dkv_library),
        "spmm_int8": (spmm_int8, spmm_int8_reference, "spmm_int8.cu",
                      "voltrix_spmm_tpu/ops/quant.py:37", quant.load_library),
    }

    # --- 2. build: one nvcc per source, all started together -----------
    def timed_build(loader):
        t0 = time.perf_counter()
        loader()
        return time.perf_counter() - t0

    # K11 and K12 share K14's and K15's builds, K13 K9's
    sources = {k[2]: k[4] for k in kernels.values()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(timed_build, sources.values())))
    t_nvcc = time.perf_counter() - t0
    print(f"build: {', '.join(f'{src} {s:.2f} s' for src, s in builds.items())}; "
          f"{t_nvcc:.2f} s in all, into {get_build_dir()}")
    # K5 and K13 (and K9 beside it) sum in a fixed order: no atomic of any
    # kind in their SASS
    for src in ("spmm_dvalues.cu", "attn_fwd.cu"):
        ops = sass_atomics.atomics(src)
        print(f"sass_atomics {src}: {dict(sorted(ops.items())) or 'no atomics'}")
        if ops:
            fail(f"{src} compiled to atomics {dict(ops)}: its sums must run in a fixed order")

    # --- 3. kernels against their plain versions --------------------------
    max_err = dict.fromkeys(kernels, 0.0)

    def compare(name, label, plan, args, deg=None):
        """The kernel against its plain version on `args` ((feat,), or
        (feat, g) for K5 and K7). With `deg` (row degrees) the allowance of
        each row also holds the textbook bound on float32 summation in any
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
            abs_plan = plan
            if name == "spmm_weighted":
                abs_plan = dataclasses.replace(plan, values=plan.values.abs())
            elif name == "spmm_ell":
                abs_plan = dataclasses.replace(plan, vals=plan.vals.abs())
            abs_sum = plain(abs_plan, args[0].abs())
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        ok = diff < 1e-6 and bool(((out_k - out_p).abs() <= allow).all())
        extra = ""
        if name == "spmm_dvalues" and out_k.numel():
            off = ~expand_bitmask(plan.bitmask, plan.config.block_h, torch.bool)
            zero = bool((out_k[off] == 0).all())
            ok = ok and zero
            extra = f", off the bitmask {'all 0.0' if zero else 'NOT ZERO'}"
        if name == "spmm_ell_dvals" and out_k.numel():
            zero = bool((out_k[plan.erow < 0] == 0).all())
            ok = ok and zero
            extra = f", padding lanes {'all 0.0' if zero else 'NOT ZERO'}"
        print(f"  {label}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e}{extra} "
              f"-> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version on {label}")

    def twice(label, kernel, plan, feat):
        """The kernel twice on the same input: the same bits, or fail."""
        same = torch.equal(kernel(plan, feat), kernel(plan, feat))
        print(f"  {label} twice: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of the kernel on the same input differ")

    walks = {"spmm_block": lambda p: block_spmm.plan_walk(p, "spmm_block"),
             "spmm_subtile": subtile_spmm.subtile_walk,
             "spmm_int8": lambda p: block_spmm.plan_walk(p, "spmm_int8"),
             "spmm_weighted": lambda p: block_spmm.plan_walk(p, "spmm_weighted"),
             "spmm_fused": lambda p: block_spmm.plan_walk(p, "spmm_fused")}

    def most_pieces(p, name):
        """The most pieces that one 128-row group of plan `p` is cut into."""
        merges = walks[name](p).merges
        return int(merges[:, 3].max()) if merges.numel() else 1

    def piece_line(label, plans, name, widths):
        """Print what K1's, K2's or K8's work list gives a path's plan (or its
        window chunks, which run one after another): pieces, windows and
        groups cut, the kept (lane, word) pairs and the work (pairs plus
        their nonzero bitmask bytes, busiest warp) of the heaviest piece
        against the mean piece, and the largest workspace at each width."""
        st = [block_spmm.walk_stats(p, walks[name](p), 1) for p in plans]
        pieces = sum(x["pieces"] for x in st)
        heavy = {k: max(x[f"max_task_{k}"] for x in st) for k in ("pairs", "work")}
        mean = {k: sum(x[f"mean_task_{k}"] * x["pieces"] for x in st) / pieces
                for k in ("pairs", "work")}
        ws = ", ".join(f"{max(x['workspace_mib'] for x in st) * d:.2f} MiB at d {d}"
                       for d in widths)
        print(f"  {label} {name} work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS[name]}, "
              f"PIECE_WORK {block_spmm.PIECE_WORK[name]}): {pieces} pieces, "
              f"{sum(x['cut_windows'] for x in st)} windows and "
              f"{sum(x['cut_groups'] for x in st)} groups cut; heaviest piece "
              f"{heavy['pairs']} kept pairs against a mean of {mean['pairs']:.1f}, "
              f"{heavy['work']} units of work against {mean['work']:.1f}; workspace {ws}")

    rng = np.random.default_rng(0)

    def feat_of(n, d):
        return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def case(name, label, a, d, cfg, expect=None, drop_occ=False, off_mask=False, feat=None,
             offset=False, bound=False, gen=None):
        """`name` against its plain version on plan `cfg` of `a` at width d.
        offset: feat is a contiguous view 4 bytes past a 16-byte boundary;
        bound: allow the float32 summation bound of `a`'s row degrees; gen:
        the generator of the values and features (the shared one if None)."""
        n = a.shape[0]
        draw = rng if gen is None else gen
        weighted_kernel = name in ("spmm_weighted", "spmm_dvalues")
        values = draw.standard_normal(a.nnz).astype(np.float32) if weighted_kernel else None
        plan = csr_preprocess(a.indptr, a.indices, n, cfg, values=values)
        if drop_occ:
            plan = dataclasses.replace(plan, occ=None)
        if off_mask:  # values in every slot, off the bitmask too: K4 reads them all
            dense = draw.standard_normal(tuple(plan.values.shape)).astype(np.float32)
            plan = dataclasses.replace(plan, values=torch.from_numpy(dense))
        if gen is not None and feat is None:
            feat = gen.standard_normal((n, d)).astype(np.float32)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        if offset:
            view = torch.empty(n * d + 1, device=dev)[1:].view(n, d)
            view.copy_(feat_of(n, d) if feat is None else torch.from_numpy(feat).to(dev))
            if view.data_ptr() % 16 != 4 or not view.is_contiguous():
                fail(f"{label}: the features are not the offset view this case is for")
            args = (view,)
        elif feat is not None:
            args = (torch.from_numpy(feat).to(dev),)
        elif name == "spmm_dvalues":
            args = (feat_of(n, d), feat_of(n, d))
        else:
            args = (feat_of(n, d),)
        deg = None
        if bound and off_mask:  # every slot of the row's window counts
            bpw = torch.diff(plan.block_ptr).float()
            deg = (bpw.repeat_interleave(plan.config.block_h)[:n] * plan.config.block_w)
            deg = deg.to(dev)[:, None]
        elif bound:
            deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        compare(name, label, plan.to(dev), args, deg)

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

    def window0_of(blocks, seed):
        """A graph whose first 128 rows reach exactly blocks x 128 distinct
        columns (row r: columns r * blocks .. r * blocks + blocks - 1), so
        window 0 of a PlanConfig(128, 128) plan holds exactly `blocks`
        blocks; the other rows are random."""
        n = blocks * 128 + 2048
        rest = rows_only(erdos_renyi_csr(n, 0.005, seed), lambda r: r >= 128)
        first = sp.csr_matrix((np.ones(128 * blocks, np.float32),
                               (np.repeat(np.arange(128), blocks), np.arange(128 * blocks))),
                              shape=(n, n))
        return ((rest + first) != 0).astype(np.float32).tocsr()

    # power-law hub windows cut into pieces; the float32 summation bound of
    # their hub rows (degrees in the thousands)
    hub40k = symmetrize(chung_lu_csr(40000, 400000, seed=34))
    for name, kid, sub_cfg in (
            (k1, "K1", {}), ("spmm_subtile", "K2", {"cluster_cols": True})):
        pb = block_spmm.PIECE_BLOCKS[name]
        if name != k1:
            print(f"kernel {kid} against its plain version (clustered plans):")
        print(f"  ({kid}'s pieces: PIECE_BLOCKS {pb}, PIECE_WORK "
              f"{block_spmm.PIECE_WORK[name]})")
        case(name, f"n40000 d128 block_h 128, block_w 32{', clustered' if sub_cfg else ''}, hub "
             "window cut into >= 16 pieces", hub40k, 128, PlanConfig(128, 32, **sub_cfg),
             expect=lambda p, name=name: most_pieces(p, name) >= 16, bound=True)
        case(name, f"n{128 * 2 * pb + 2048} d64 window 0 of exactly 2 x {pb} blocks",
             window0_of(2 * pb, 35), 64, PlanConfig(128, 128, **sub_cfg),
             expect=lambda p, pb=pb: int(p.block_ptr[1]) == 2 * pb)
        wide = PlanConfig(2048, 128, block_unroll=4, **sub_cfg) if sub_cfg else PlanConfig(128, 128)
        wide_label = f"block_h {wide.block_h}, block_w 128{', clustered' if sub_cfg else ''}"
        case(name, f"n40000 d256 {wide_label}, hub windows cut", hub40k, 256, wide,
             expect=lambda p, name=name: most_pieces(p, name) >= 4, bound=True)
        case(name, f"n40000 d130 {wide_label} (unaligned rows: 4-byte copies)", hub40k, 130,
             wide, bound=True)
        case(name, f"n40000 d128 {wide_label}, feat 4 bytes past a 16-byte boundary", hub40k,
             128, wide, offset=True, bound=True)

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
    # K3's work list and both its walks: hub windows cut into pieces (J.2's
    # geometry and C's), the narrow walk (d <= 32), 4-byte copies (d 130,
    # features off a 16-byte boundary), tensor-map boxes (d > 128) past n
    # and empty windows; features from a generator of their own, so those
    # of the paths below stay as they were
    rng3 = np.random.default_rng(97)
    j2_geometry = PlanConfig(128, 128, gather_segment=8)
    c_geometry = PlanConfig(2048, 128, gather_segment=128, block_unroll=4)
    print(f"  (K3's pieces: PIECE_BLOCKS {block_spmm.PIECE_BLOCKS[k3]}, PIECE_WORK "
          f"{block_spmm.PIECE_WORK[k3]})")
    hub1m = symmetrize(chung_lu_csr(40000, 1000000, seed=36))
    for d in (128, 256, 8):
        case(k3, f"n40000 {hub1m.nnz} nnz d{d} PlanConfig(128,128,gather_segment=8), hub window "
             "cut into >= 16 pieces", hub1m, d, j2_geometry,
             expect=lambda p: most_pieces(p, k3) >= 16, bound=True, gen=rng3)
    case(k3, "n40000 d130 PlanConfig(2048,128,gather_segment=128,block_unroll=4) (unaligned "
         "rows: 4-byte copies)", hub40k, 130, c_geometry, bound=True, gen=rng3)
    case(k3, "n40000 d300 PlanConfig(2048,128,gather_segment=128,block_unroll=4) (boxes, a "
         "partial column chunk)", hub40k, 300, c_geometry, bound=True, gen=rng3)
    for d in (128, 8):
        case(k3, f"n40000 d{d} PlanConfig(512,128,gather_segment=8), feat 4 bytes past a 16-byte "
             "boundary", hub40k, d, PlanConfig(512, 128, gather_segment=8), offset=True,
             bound=True, gen=rng3)
    for d in (256, 8):
        case(k3, f"n5000 d{d} PlanConfig(2048,128,gather_segment=128,block_unroll=4), tail past n",
             erdos_renyi_csr(5000, 0.01, 17), d, c_geometry,
             expect=lambda p: int(p.hind.max()) >= 5000, gen=rng3)
        case(k3, f"n2048 d{d} empty windows padded with zero-bit blocks",
             rows_only(erdos_renyi_csr(2048, 0.01, 18), lambda r: not 256 <= r < 512), d,
             PlanConfig(128, 128, gather_segment=8), expect=lambda p: not p.has_empty_windows,
             gen=rng3)
        case(k3, f"n40960 d{d} empty windows left without blocks (tall windows)",
             rows_only(erdos_renyi_csr(40960, 0.0005, 19), lambda r: r < 2048), d, c_geometry,
             expect=lambda p: p.has_empty_windows, gen=rng3)
    # runs that cross the 128-lane tiles the producer stages (block_w 384):
    # tensor-map boxes of 8-64 rows (seg 24, 48, 96, 192), and 4-byte copies
    # where a box would be under 8 rows (seg 12)
    for d, seg in ((128, 48), (256, 48), (256, 24), (128, 96), (256, 192), (8, 48), (128, 12)):
        case(k3, f"n40000 d{d} PlanConfig(128,384,gather_segment={seg}), runs across tiles",
             hub40k, d, PlanConfig(128, 384, gather_segment=seg), bound=True, gen=rng3)

    hub = symmetrize(chung_lu_csr(8000, 80000, seed=23))  # hub windows cut into K4 pieces
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

    # K4's work list: hub windows cut into pieces of at most PIECE_BLOCKS
    # blocks, merged in piece order; the float32 summation bound of the rows'
    # terms (their degrees, or every slot of their window's blocks); values
    # and features from a generator of their own, as K8's cases, so those of
    # the paths below stay as they were
    k4, pb = "spmm_weighted", block_spmm.PIECE_BLOCKS["spmm_weighted"]
    print(f"kernel K4 on its work list (PIECE_BLOCKS {pb}):")
    rng4 = np.random.default_rng(96)
    case(k4, "n40000 d40 PlanConfig(64,128), hub window cut into >= 16 pieces", hub40k, 40,
         PlanConfig(64, 128), expect=lambda p: most_pieces(p, k4) >= 16, bound=True, gen=rng4)
    case(k4, f"n{128 * 2 * pb + 2048} d40 PlanConfig(128,128), window 0 of exactly 2 x {pb} "
         "blocks", window0_of(2 * pb, 36), 40, PlanConfig(128, 128),
         expect=lambda p: int(p.block_ptr[1]) == 2 * pb, gen=rng4)
    case(k4, "n40000 d130 PlanConfig(64,128), hub windows cut (unaligned rows: 4-byte copies)",
         hub40k, 130, PlanConfig(64, 128), expect=lambda p: most_pieces(p, k4) >= 16,
         bound=True, gen=rng4)
    case(k4, "n8000 d40 PlanConfig(64,128), values off the bitmask on cut windows", hub, 40,
         PlanConfig(64, 128), expect=lambda p: most_pieces(p, k4) >= 4, off_mask=True,
         bound=True, gen=rng4)

    # K5 at set bits only, over its work list (PIECE_BLOCKS["spmm_dvalues"]):
    # each case twice on one input, the same bits; block_w 256, bits on rows
    # at num_nodes and beyond (0.0 there), hind outside the source rows
    # (clipped), hub windows cut into pieces, two 128-row groups, three
    # words a group; features and dO from a generator of their own
    print(f"kernel K5 on its work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS['spmm_dvalues']}), "
          "each case twice:")
    rng5 = np.random.default_rng(92)

    def k5_case(label, a, d, cfg, edit=None, expect=None):
        n = a.shape[0]
        plan = csr_preprocess(a.indptr, a.indices, n, cfg)
        last = (plan.window_of_block == plan.num_windows - 1).numpy()
        if edit == "rows_past_n":  # bits on the last window's rows n .. padded_nodes - 1
            if not last.any():
                fail(f"{label}: the last window has no blocks")
            bm = plan.bitmask.numpy().copy()
            r0 = n - (plan.num_windows - 1) * cfg.block_h
            for r in range(r0, cfg.block_h):
                bm[last, r // 32, ::3] |= np.int32(np.uint32(1 << (r % 32)).view(np.int32))
            plan = dataclasses.replace(plan, bitmask=torch.from_numpy(bm))
        if edit == "clipped":  # a fifth of the lanes with bits gather past the source rows
            hind = plan.hind.numpy().copy().reshape(-1)
            held = np.flatnonzero((plan.bitmask.numpy() != 0).any(1).reshape(-1))
            hind[held[::10]], hind[held[5::10]] = n + 11, -4
            plan = dataclasses.replace(plan, hind=torch.from_numpy(hind.reshape(plan.hind.shape)))
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        plan = plan.to(dev)
        feat, grad = (torch.from_numpy(rng5.standard_normal((n, d)).astype(np.float32)).to(dev)
                      for _ in range(2))
        compare("spmm_dvalues", label, plan, (feat, grad))
        out = spmm_weighted_dvalues(plan, feat, grad)
        twice(f"  K5 {label}", lambda p, f: spmm_weighted_dvalues(p, f, grad), plan, feat)
        if edit == "rows_past_n":
            past = out[torch.from_numpy(last).to(dev)][:, r0:]
            if not bool((past == 0).all()):
                fail(f"K5 {label}: rows past num_nodes are not 0.0")
            print(f"    rows past num_nodes: {past.numel()} values, all 0.0")

    k5_case("n3000 d8 PlanConfig(64,128)", erdos_renyi_csr(3000, 0.01, 24), 8, PlanConfig(64, 128))
    k5_case("n3000 d40 PlanConfig(64,128,block_unroll=2)", erdos_renyi_csr(3000, 0.01, 25), 40,
            PlanConfig(64, 128, block_unroll=2))
    k5_case("n1000 d100 PlanConfig(32,128) (two column chunks, unaligned d)",
            erdos_renyi_csr(1000, 0.02, 26), 100, PlanConfig(32, 128))
    k5_case("n1000 d13 PlanConfig(64,128) (4-byte copies)", erdos_renyi_csr(1000, 0.02, 27), 13,
            PlanConfig(64, 128))
    k5_case("n700 d64 PlanConfig(32,256) (block_w 256)", erdos_renyi_csr(700, 0.02, 28), 64,
            PlanConfig(32, 256))
    k5_case("n300 d40 PlanConfig(64,128), bits on rows 300-319 past num_nodes",
            erdos_renyi_csr(300, 0.03, 29), 40, PlanConfig(64, 128), edit="rows_past_n")
    k5_case("n1000 d40 PlanConfig(64,128), hind outside [0, n) on a fifth of the lanes "
            "with bits", erdos_renyi_csr(1000, 0.02, 30), 40, PlanConfig(64, 128), edit="clipped")
    k5_case("n8000 d40 PlanConfig(64,128), power-law hub windows cut into pieces", hub, 40,
            PlanConfig(64, 128), expect=lambda p: int(torch.diff(p.block_ptr).max())
            > 2 * block_spmm.PIECE_BLOCKS["spmm_dvalues"])
    k5_case("n3000 d40 PlanConfig(256,128) (two 128-row groups)", erdos_renyi_csr(3000, 0.01, 31),
            40, PlanConfig(256, 128))
    k5_case("n1500 d24 PlanConfig(96,128) (three words a group)",
            erdos_renyi_csr(1500, 0.01, 33), 24, PlanConfig(96, 128))
    k5_case("n10240 d8 empty windows left without blocks",
            rows_only(erdos_renyi_csr(10240, 0.002, 30), lambda r: r < 64), 8,
            PlanConfig(64, 128), expect=lambda p: p.has_empty_windows)

    def with_duplicates(a, seed):
        """(indptr, indices, n) of `a` with a fifth of its edges repeated:
        duplicate edges keep separate ELL lanes and sum."""
        coo = a.tocoo()
        pick = np.random.default_rng(seed).random(coo.nnz) < 0.2
        rows = np.concatenate([coo.row, coo.row[pick]])
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(a.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=a.shape[0]), out=indptr[1:])
        return indptr, np.concatenate([coo.col, coo.col[pick]])[order], a.shape[0]

    def ell_case(name, label, a, d, cfg, num_cols=None, expect=None, pad_vals=False,
                 misaligned=False, gen=None):
        """K6 or K7 against its plain version on an ELL plan of `a` (a CSR,
        or (indptr, indices, n)) with random edge values; gen: the generator
        of the values and features (the shared one if None)."""
        draw = rng if gen is None else gen
        indptr, indices, n = (a.indptr, a.indices, a.shape[0]) if sp.issparse(a) else a
        values = draw.standard_normal(len(indices)).astype(np.float32)
        plan = csr_preprocess_ell(indptr, indices, n, cfg, values=values, num_cols=num_cols)
        if pad_vals:  # values on padding lanes: K6 must ignore them
            pad = plan.erow < 0
            vals = plan.vals.clone()
            vals[pad] = torch.from_numpy(draw.standard_normal(int(pad.sum())).astype(np.float32))
            plan = dataclasses.replace(plan, vals=vals)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        src = num_cols or n

        def draw_feat(rows):
            if gen is None:
                return feat_of(rows, d)
            return torch.from_numpy(gen.standard_normal((rows, d)).astype(np.float32)).to(dev)

        feat = draw_feat(src)
        if misaligned:  # 4 bytes past a 16-byte boundary: K7 takes scalar loads
            buf = torch.empty(src * d + 1, device=dev)
            buf[1:] = feat.reshape(-1)
            feat = buf[1:].view(src, d)
        args = (feat,) if name == "spmm_ell" else (feat, draw_feat(n))
        compare(name, label, plan.to(dev), args)

    for name, kid in (("spmm_ell", "K6"), ("spmm_ell_dvals", "K7")):
        print(f"kernel {kid} against its plain version (ELL plans):")
        ell_case(name, "n3001 d8 PlanConfig(128,128,block_unroll=4) (unaligned n)",
                 erdos_renyi_csr(3001, 0.005, 40), 8, PlanConfig(128, 128, block_unroll=4))
        ell_case(name, "n1000 d40 PlanConfig(64,128)", erdos_renyi_csr(1000, 0.02, 41), 40,
                 PlanConfig(64, 128))
        ell_case(name, "n700 d1 PlanConfig(32,128)", erdos_renyi_csr(700, 0.02, 42), 1,
                 PlanConfig(32, 128))
        ell_case(name, "n2000 d256 PlanConfig(128,128,block_unroll=4)",
                 erdos_renyi_csr(2000, 0.02, 43), 256, PlanConfig(128, 128, block_unroll=4))
        ell_case(name, "n800 d40 PlanConfig(32,128,block_unroll=4), duplicate edges",
                 with_duplicates(erdos_renyi_csr(800, 0.02, 44), 44), 40,
                 PlanConfig(32, 128, block_unroll=4))
        ell_case(name, "500 x 900 d64 PlanConfig(64,128) (rectangular)",
                 sp.random(500, 900, density=0.02, format="csr",
                           random_state=np.random.default_rng(45)), 64, PlanConfig(64, 128),
                 num_cols=900)
        ell_case(name, "n500 d8 empty matrix (padding blocks only)",
                 erdos_renyi_csr(500, 0.0, 46), 8, PlanConfig(128, 128),
                 expect=lambda p: p.total_blocks > 0 and bool((p.erow < 0).all()))
        ell_case(name, "n12800 d8 empty matrix, no blocks", erdos_renyi_csr(12800, 0.0, 47), 8,
                 PlanConfig(128, 128), expect=lambda p: p.total_blocks == 0)
        ell_case(name, "n10240 d40 empty windows left without blocks",
                 rows_only(erdos_renyi_csr(10240, 0.002, 48), lambda r: r < 128), 40,
                 PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
        ell_case(name, "n4000 d40 PlanConfig(128,128), values on padding lanes",
                 erdos_renyi_csr(4000, 0.005, 49), 40, PlanConfig(128, 128), pad_vals=True,
                 expect=lambda p: bool((p.erow < 0).any()))
        ell_case(name, "n8000 d40 PlanConfig(128,128,block_unroll=4), power-law hub windows",
                 hub, 40, PlanConfig(128, 128, block_unroll=4),
                 expect=lambda p: int(torch.diff(p.block_ptr).max()) > 16)
        ell_case(name, "n3000 d100 PlanConfig(128,256)", erdos_renyi_csr(3000, 0.01, 50), 100,
                 PlanConfig(128, 256))
        ell_case(name, "n6000 d64 PlanConfig(2048,128) (tall windows, 16-column tile)",
                 erdos_renyi_csr(6000, 0.005, 51), 64, PlanConfig(2048, 128))
        ell_case(name, "n2000 d40 PlanConfig(128,128), misaligned features",
                 erdos_renyi_csr(2000, 0.01, 52), 40, PlanConfig(128, 128), misaligned=True)
    # K7's wide kernel (rows of at least DVALS_WIDE_MIN_D floats) and its
    # source order cut into pieces; values and features from a generator of
    # their own, so those of the paths below stay as they were
    rng7 = np.random.default_rng(98)
    print(f"  (K7's wide kernel from d {ell.DVALS_WIDE_MIN_D}, pieces of at most "
          f"{ell.DVALS_PIECE_LANES} lanes)")

    def cut_sources(p):
        """Some window's lanes are cut into two or more wide pieces."""
        w = ell.ell_source_order(p, ell.DVALS_PIECE_LANES).pieces[:, 0]
        return w.numel() > 0 and int(torch.bincount(w).max()) >= 2

    k7 = "spmm_ell_dvals"
    ell_case(k7, "n2000 d300 PlanConfig(128,128,block_unroll=4) (wide, 3 float4 a lane)",
             erdos_renyi_csr(2000, 0.02, 53), 300, PlanConfig(128, 128, block_unroll=4),
             gen=rng7)
    ell_case(k7, "n2000 d256 PlanConfig(128,128), misaligned features (sub-group kernel)",
             erdos_renyi_csr(2000, 0.02, 54), 256, PlanConfig(128, 128), misaligned=True,
             gen=rng7)
    hub_cand = symmetrize(chung_lu_csr(8000, 400000, seed=55))
    for d in (256, ell.DVALS_WIDE_MIN_D):
        ell_case(k7, f"n8000 d{d} PlanConfig(128,128,block_unroll=4), power-law hub windows "
                 "with padding lanes, cut into pieces", hub_cand, d,
                 PlanConfig(128, 128, block_unroll=4),
                 expect=lambda p: bool((p.erow < 0).any()) and cut_sources(p), gen=rng7)

    print("kernel K8 against its plain version (int8 rows, bf16 dequantization):")
    k8 = "spmm_int8"
    case(k8, "n512 d64 PlanConfig(32,128)", erdos_renyi_csr(512, 0.05, 80), 64,
         PlanConfig(32, 128))
    case(k8, "n300 d130 PlanConfig(32,128) (d not a multiple of 4)",
         erdos_renyi_csr(300, 0.02, 81), 130, PlanConfig(32, 128))
    case(k8, "n700 d1 PlanConfig(32,128)", erdos_renyi_csr(700, 0.02, 82), 1, PlanConfig(32, 128))
    case(k8, "n3000 d300 PlanConfig(128,128), bit 31 set", erdos_renyi_csr(3000, 0.02, 83), 300,
         PlanConfig(128, 128), expect=lambda p: bool((p.bitmask < 0).any()))
    case(k8, "n700 d72 PlanConfig(48,128) (block_h not a multiple of 32)",
         erdos_renyi_csr(700, 0.02, 84), 72, PlanConfig(48, 128))
    case(k8, "n1000 d256 PlanConfig(128,256)", erdos_renyi_csr(1000, 0.01, 85), 256,
         PlanConfig(128, 256))
    case(k8, "n6000 d96 PlanConfig(512,128,block_unroll=4,cluster_cols=True) (occ ignored)",
         community, 96, PlanConfig(512, 128, block_unroll=4, cluster_cols=True),
         expect=lambda p: bool((p.occ != 15).any()))
    case(k8, "n3001 d64 PlanConfig(128,128,gather_segment=8), tail past n",
         erdos_renyi_csr(3001, 0.01, 86), 64, PlanConfig(128, 128, gather_segment=8),
         expect=lambda p: int(p.hind.max()) >= 3001)
    case(k8, "n5000 d96 PlanConfig(2048,128,gather_segment=128,block_unroll=4), tail past n",
         erdos_renyi_csr(5000, 0.01, 87), 96,
         PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
         expect=lambda p: int(p.hind.max()) >= 5000)
    case(k8, "n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 88), lambda r: r < 128), 128,
         PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
    case(k8, "n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 89), lambda r: not 256 <= r < 512), 96,
         PlanConfig(128, 128), expect=lambda p: not p.has_empty_windows and zero_block(p))
    case(k8, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 90), 64, PlanConfig(128, 128),
         expect=lambda p: p.total_blocks == 0)
    zero_rows = rng.standard_normal((2048, 40)).astype(np.float32)
    zero_rows[::3] = 0.0
    case(k8, "n2048 d40 PlanConfig(64,128), every third feature row all zero",
         erdos_renyi_csr(2048, 0.01, 91), 40, PlanConfig(64, 128), feat=zero_rows)
    case(k8, "n3000 d64 PlanConfig(32,128), gen_outlier_normal rows",
         erdos_renyi_csr(3000, 0.01, 92), 64, PlanConfig(32, 128),
         feat=gen_outlier_normal((3000, 64), outlier_frac=0.02, seed=1))
    dup_ptr, dup_idx, dup_n = with_duplicates(erdos_renyi_csr(800, 0.02, 93), 93)
    case(k8, "n800 d40 PlanConfig(32,128), duplicate edges",
         sp.csr_matrix((np.ones(len(dup_idx), np.float32), dup_idx, dup_ptr), shape=(dup_n, dup_n)),
         40, PlanConfig(32, 128))
    # K8 on K1's walk: a power-law hub window cut into pieces, a window of
    # exactly 2 x PIECE_BLOCKS blocks, d 130; the hub rows under the float32
    # summation bound; features from a generator of their own, so those of
    # the paths below stay as they were
    pb8 = block_spmm.PIECE_BLOCKS[k8]
    print(f"  (K8's pieces: PIECE_BLOCKS {pb8}, PIECE_WORK {block_spmm.PIECE_WORK[k8]})")
    rng8 = np.random.default_rng(94)

    def feat8(n, d):
        return rng8.standard_normal((n, d)).astype(np.float32)

    case(k8, "n40000 d128 block_h 128, block_w 32, hub window cut into >= 16 pieces", hub40k,
         128, PlanConfig(128, 32), feat=feat8(40000, 128),
         expect=lambda p: most_pieces(p, k8) >= 16, bound=True)
    case(k8, f"n{128 * 2 * pb8 + 2048} d64 window 0 of exactly 2 x {pb8} blocks",
         window0_of(2 * pb8, 95), 64, PlanConfig(128, 128), feat=feat8(128 * 2 * pb8 + 2048, 64),
         expect=lambda p: int(p.block_ptr[1]) == 2 * pb8)
    case(k8, "n40000 d130 block_h 128, block_w 128 (int8 rows of 132 bytes), hub window cut",
         hub40k, 130, PlanConfig(128, 128), feat=feat8(40000, 130),
         expect=lambda p: most_pieces(p, k8) >= 4, bound=True)

    def close(name, label, got, want, extra=""):
        """One K13-K15 output against its plain version: calc_diff < 1e-6 and
        |got - want| <= 1e-4 |want| + 1e-5 max|want| (float32 sums in another
        order, a softmax merged across tasks)."""
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name} {label}: kernel output {tuple(got.shape)} is not a finite "
                 f"{tuple(want.shape)}")
        scale = want.abs().max().item() if want.numel() else 0.0
        diff = calc_diff(got, want)
        err = (got - want).abs().max().item() if got.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        ok = diff < 1e-6 and torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
        print(f"    {name} {label}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e} "
              f"(max|plain| {scale:.3e}){extra} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version on {label}")

    def fwd_close(name, label, nq, out_k, lse_k, out_p, lse_p):
        """A forward's out and lse (last axis: rows) against its plain
        version's; rows without edges exactly 0 with lse exactly 1e30."""
        empty = lse_p == 1e30
        rows_empty = empty[..., :nq]
        exact = bool((lse_k[empty] == 1e30).all()) and bool((out_k[rows_empty] == 0).all())
        close(name, f"{label} out", out_k, out_p)
        finite = ~empty
        lse_err = (lse_k[finite] - lse_p[finite]).abs().max().item() if finite.any() else 0.0
        lse_ok = lse_err <= 1e-5 * max(1.0, lse_p[finite].abs().max().item()) and exact
        print(f"    {name} {label} lse: max|kernel - plain| {lse_err:.3e}; "
              f"{int(rows_empty.sum())} (head, row) pairs without edges "
              f"{'exactly 0 / 1e30' if exact else 'NOT EXACT'} -> {'ok' if lse_ok else 'MISMATCH'}")
        if not lse_ok:
            fail(f"kernel {name}'s lse disagrees with its plain version on {label}")

    def attn1_compare(label, plan, plan_t, q, k, v, g, slope):
        """K9, K10, K11 and K12 against their plain versions on one head (q
        (n, dk) etc.); the backward takes the plain forward's out and lse.
        K10's lane planes must be exactly 0 on lanes without bits."""
        kw = dict(negative_slope=slope)
        out_k, lse_k = spmm_attention(plan, q, k, v, return_stats=True, **kw)
        out_p, lse_p = spmm_attention_reference(plan, q, k, v, return_stats=True, **kw)
        torch.cuda.synchronize()
        fwd_close("attn_fwd", label, plan.num_nodes, out_k, lse_k, out_p, lse_p)
        kw["scale"] = 1.0 / q.shape[1] ** 0.5
        got = attention_bwd(plan, q, k, v, out_p, lse_p, g, **kw)
        want = attention_bwd_reference(plan, q, k, v, out_p, lse_p, g, **kw)
        unset = (plan.bitmask == 0).all(1).reshape(-1)
        zero = all(bool((t[unset] == 0).all()) for t in got[1:])
        extra = f", {int(unset.sum())} lanes without bits {'all 0.0' if zero else 'NOT ZERO'}"
        for part, a, b in zip(("dq", "dk lanes", "dv lanes"), got, want):
            close("attn_bwd", f"{label} {part}", a, b, extra if part != "dq" else "")
        if not zero:
            fail(f"kernel attn_bwd writes lanes without bits on {label}")
        # K10 with its fixed-order sum against the plain planes summed by scatter_lanes
        summed = attention_bwd_summed(plan, q, k, v, out_p, lse_p, g, **kw)
        nk = k.shape[0]
        plain = (want[0], scatter_lanes(plan, want[1], nk), scatter_lanes(plan, want[2], nk))
        for part, a, b in zip(("dq", "dk", "dv"), summed, plain):
            close("attn_bwd", f"{label} summed {part}", a, b)
        bwd = (q, k, v, g, lse_p, (g * out_p).sum(-1))
        close("attn_dq", f"{label} dq", attention_dq(plan, *bwd, **kw),
              attention_dq_reference(plan, *bwd, **kw))
        for part, a, b in zip(("dk", "dv"), attention_dkv(plan_t, *bwd, **kw),
                              attention_dkv_reference(plan_t, *bwd, **kw)):
            close("attn_dkv", f"{label} {part}", a, b)

    def attn_compare(label, plan, plan_t, q, k, v, g, slope, pdt):
        """K13, K14 and K15 against their plain versions on one problem; the
        backward takes the plain forward's lse and D. Rows without edges
        must come out exactly 0 with lse exactly 1e30, and K13 twice on the
        same input the same bits."""
        kw = dict(negative_slope=slope, plane_dtype=pdt)
        scale = 1.0 / q.shape[2] ** 0.5
        out_k, lse_k = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
        out_p, lse_p = spmm_attention_mh_reference(plan, q, k, v, return_stats=True, **kw)
        torch.cuda.synchronize()
        fwd_close("attn_mh_fwd", label, plan.num_nodes, out_k, lse_k, out_p, lse_p)
        again = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
        same = torch.equal(again[0], out_k) and torch.equal(again[1], lse_k)
        print(f"    attn_mh_fwd {label}: K13 (out, lse) twice "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of K13 on the same input differ")
        d_row = (g * out_p).sum(-1)
        bwd = (q, k, v, g, lse_p, d_row)
        kw["scale"] = scale
        close("attn_mh_dq", f"{label} dq", attention_mh_dq(plan, *bwd, **kw),
              attention_mh_dq_reference(plan, *bwd, **kw))
        dk_k, dv_k = attention_mh_dkv(plan_t, *bwd, **kw)
        dk_p, dv_p = attention_mh_dkv_reference(plan_t, *bwd, **kw)
        close("attn_mh_dkv", f"{label} dk", dk_k, dk_p)
        close("attn_mh_dkv", f"{label} dv", dv_k, dv_p)

    def attn_case(label, a, cfg, heads, dk, dv, slope=0.2, pdt=None, cfg_t=None, expect=None):
        """K13-K15 on plans of `a` and of its transpose (`cfg_t`, default
        `cfg`), with random q, k, v and dO."""
        n = a.shape[0]
        at = a.T.tocsr()
        plan = csr_preprocess(a.indptr, a.indices, n, cfg)
        plan_t = csr_preprocess(at.indptr, at.indices, n, cfg_t or cfg)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        q, k, g = (feat_of(heads * n, d).view(heads, n, d) for d in (dk, dk, dv))
        v = feat_of(heads * n, dv).view(heads, n, dv)
        pname = "bf16" if pdt is not None else "f32"
        print(f"  {label}, H {heads}, dk {dk}, dv {dv}, slope {slope}, {pname} planes:")
        plan, plan_t = plan.to(dev), plan_t.to(dev)
        attn_compare(label, plan, plan_t, q, k, v, g, slope, pdt)
        print(f"  {label}, head 0, dk {dk}, dv {dv}, slope {slope}, float32:")
        attn1_compare(label, plan, plan_t, q[0], k[0], v[0], g[0], slope)

    def isolated(a, keep):
        """`a` with the rows and columns r for which keep(r) is false emptied."""
        d = sp.diags(np.array([1.0 if keep(r) else 0.0 for r in range(a.shape[0])]))
        b = (d @ a @ d).tocsr()
        b.eliminate_zeros()
        return b

    print("kernels K13, K14 and K15 (multi-head attention) and K9-K12 (one head) against "
          "their plain versions:")
    bf16 = torch.bfloat16
    er = erdos_renyi_csr(3001, 0.005, 60)
    attn_case("n3001 PlanConfig(128,128,block_unroll=4)", er, PlanConfig(128, 128, block_unroll=4),
              8, 8, 8)
    attn_case("n3001 PlanConfig(128,128,block_unroll=4)", er, PlanConfig(128, 128, block_unroll=4),
              8, 8, 8, pdt=bf16)
    attn_case("n2000 PlanConfig(128,128,block_unroll=4)", erdos_renyi_csr(2000, 0.01, 61),
              PlanConfig(128, 128, block_unroll=4), 1, 40, 40, pdt=bf16)
    attn_case("n1500 PlanConfig(32,128)", erdos_renyi_csr(1500, 0.01, 62), PlanConfig(32, 128),
              3, 12, 20, slope=1.0)
    attn_case("n1200 PlanConfig(64,128) (widths not a multiple of 4)",
              erdos_renyi_csr(1200, 0.01, 63), PlanConfig(64, 128), 3, 10, 6)
    directed = sp.random(2000, 2000, density=0.005, format="csr",
                         random_state=np.random.default_rng(64))
    directed.data[:] = 1.0
    for pdt in (None, bf16):
        attn_case("n2000 directed, PlanConfig(32,128), A^T PlanConfig(64,128,block_unroll=2)",
                  directed, PlanConfig(32, 128), 3, 12, 20, pdt=pdt,
                  cfg_t=PlanConfig(64, 128, block_unroll=2))
    attn_case("n10240 empty windows left without blocks",
              rows_only(erdos_renyi_csr(10240, 0.002, 65), lambda r: r < 128),
              PlanConfig(128, 128), 2, 8, 8, expect=lambda p: p.has_empty_windows)
    attn_case("n3000 isolated rows (every 7th), tail windows of zero-bit blocks",
              isolated(erdos_renyi_csr(3000, 0.005, 66), lambda r: r % 7 and r < 2700),
              PlanConfig(64, 128, block_unroll=2), 3, 8, 8, pdt=bf16, expect=zero_block)
    for heads, dk, dv, pdt in ((8, 8, 8, bf16), (1, 40, 40, None), (1, 40, 200, bf16)):
        attn_case("n8000 power-law hub windows cut over several tasks", hub,
                  PlanConfig(128, 128, block_unroll=4), heads, dk, dv, pdt=pdt,
                  expect=lambda p: int(torch.diff(p.block_ptr).max()) > 16)
    attn_case("n700 PlanConfig(48,128) (block_h not a multiple of 32)",
              erdos_renyi_csr(700, 0.02, 67), PlanConfig(48, 128), 2, 8, 8)
    attn_case("n3000 PlanConfig(256,128)", erdos_renyi_csr(3000, 0.01, 68), PlanConfig(256, 128),
              2, 16, 16, pdt=bf16)
    attn_case("n3000 PlanConfig(128,256)", erdos_renyi_csr(3000, 0.01, 69), PlanConfig(128, 256),
              2, 16, 16)
    attn_case("n1000 PlanConfig(2048,128) (tall windows, narrow tiles)",
              erdos_renyi_csr(1000, 0.01, 70), PlanConfig(2048, 128), 1, 300, 300)

    def attn_pieces(plan, d):
        """What K9's work list gives `plan`: pieces, windows cut, the most
        pieces of one window, the heaviest piece's work against the mean,
        the workspace at width d."""
        st = attention.attention_walk_stats(plan, "spmm_attention", d)
        most = int(torch.bincount(
            attention.attention_walk(plan, "spmm_attention").tasks[:, 0].long()).max())
        return (f"K9's work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS['spmm_attention']}, "
                f"PIECE_WORK {block_spmm.PIECE_WORK['spmm_attention']}): {st['pieces']} pieces, "
                f"{st['cut_windows']} windows cut, at most {most} in one window, heaviest "
                f"{st['max_task_work']} units of work against a mean of "
                f"{st['mean_task_work']:.1f}, workspace {st['workspace_mib']:.2f} MiB at d {d}")

    def attn_twice(label, plan, q, k, v, g):
        """K9 (out, lse) and K10 with its fixed-order sum (dq, dk, dv) twice
        on the same input: the same bits, or fail."""
        a1 = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
        a2 = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
        kw = dict(scale=1.0 / q.shape[1] ** 0.5, negative_slope=0.2)
        b1 = attention_bwd_summed(plan, q, k, v, *a1, g, **kw)
        b2 = attention_bwd_summed(plan, q, k, v, *a1, g, **kw)
        same = all(torch.equal(x, y) for x, y in zip((*a1, *b1), (*a2, *b2)))
        print(f"    K9 (out, lse) and K10 (dq, summed dk and dv) twice on {label}: "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of K9 or K10 on the same input differ")

    rng9 = np.random.default_rng(96)

    def attn1_case(label, a, cfg, d, offset=False, expect=None):
        """K9, K10 and K10's fixed-order sum (and K11, K12) against their plain
        versions on one head of width d, q, k, v and dO from a generator of
        their own (with `offset`, views 4 bytes past a 16-byte boundary), then
        K9 and K10 twice on the same input."""
        n = a.shape[0]
        at = a.T.tocsr()
        plan = csr_preprocess(a.indptr, a.indices, n, cfg).to(dev)
        plan_t = csr_preprocess(at.indptr, at.indices, n, cfg).to(dev)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")

        def rows():
            x = torch.from_numpy(rng9.standard_normal((n, d)).astype(np.float32)).to(dev)
            if not offset:
                return x
            buf = torch.empty(n * d + 1, device=dev)
            buf[1:] = x.reshape(-1)
            return buf[1:].view(n, d)

        q, k, v, g = rows(), rows(), rows(), rows()
        print(f"  {label}, d {d}{', rows 4 bytes past a 16-byte boundary' if offset else ''}: "
              f"{attn_pieces(plan, d)}")
        attn1_compare(label, plan, plan_t, q, k, v, g, 0.2)
        attn_twice(label, plan, q, k, v, g)

    def k9_most_pieces(p):
        return int(torch.bincount(
            attention.attention_walk(p, "spmm_attention").tasks[:, 0].long()).max())

    print("kernels K9 and K10 (and K10's fixed-order sum) on their work list:")
    for d in (8, 12, 40):
        attn1_case("n8000 power-law hub window cut into >= 16 pieces", hub,
                   PlanConfig(128, 128, block_unroll=4), d,
                   expect=lambda p: k9_most_pieces(p) >= 16)
    attn1_case("n8000 power-law hub window cut into >= 16 pieces", hub,
               PlanConfig(128, 128, block_unroll=4), 40, offset=True,
               expect=lambda p: k9_most_pieces(p) >= 16)
    attn1_case("n3001 PlanConfig(128,128,block_unroll=4), a tail window past n", er,
               PlanConfig(128, 128, block_unroll=4), 12, offset=True,
               expect=lambda p: p.num_nodes % 128 != 0)
    attn1_case("n10240 empty windows left without blocks",
               rows_only(erdos_renyi_csr(10240, 0.002, 65), lambda r: r < 128),
               PlanConfig(128, 128), 40, expect=lambda p: p.has_empty_windows)
    attn1_case("n3000 isolated rows (every 7th), tail windows of zero-bit blocks",
               isolated(erdos_renyi_csr(3000, 0.005, 66), lambda r: r % 7 and r < 2700),
               PlanConfig(64, 128, block_unroll=2), 40, expect=zero_block)

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

    @contextlib.contextmanager
    def deterministic():
        """torch's deterministic mode, for the plain path that the training
        checks compare with: its index_add_ sums then come out the same in
        every run, as K13's do, so an edge whose score lies within rounding
        of leaky_relu's kink takes the same slope on each side in every run
        and the comparison does not change from run to run."""
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

    def train(label, loss_fn, step, params, g, x, y, want_launches, atol_scale, **tol):
        """STEPS calls of step(params, g, x, y) (a training step over an
        optimizer that holds `params`) on the kernel path, counted; step 0's
        loss and gradients against loss_fn(..., impl="reference") from the
        same parameters (see grads_close for atol_scale and the tolerances
        `tol` may set). Returns (losses,
        launch counts, final loss, peak GiB)."""
        pref = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        with deterministic():
            loss_ref = loss_fn(pref, g, x, y, impl="reference")
            want = dict(zip(pref, torch.autograd.grad(loss_ref, list(pref.values()))))
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
        ok, diff, rel = grads_close(torch, calc_diff, grads0, want, atol_scale, **tol)
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

    def time_steps(step, params, g, x, y):
        """The training step on the kernel path and on the plain path, in
        turns, and a profile of 3 steps on the kernel path."""
        k_ms, p_ms, turns = in_turns(torch, lambda: step(params, g, x, y),
                                     lambda: step(params, g, x, y, impl="reference"),
                                     plain_iters=2)
        print(f"  training step: kernel path {k_ms:.4f} ms ({turns[1]:.4f} / {turns[2]:.4f}), "
              f"plain path {p_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        print_profile(*profile_requests(torch, lambda: step(params, g, x, y)), "training step")
        return k_ms, p_ms

    def serve(label, a, cfg, name, widths, host_rows=None, train_gcn=False, then=None):
        """Build the graph, serve REQUESTS requests on kernel `name`, check
        counts and logits, hold the kernel against its plain version at
        the path's widths, time both and the library call in turns, and
        (train_gcn) train the GCN on the same graph. Last, then(g, model,
        params_np, xs, logits) drives the paths that reuse the graph."""
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
        if name in walks:
            piece_line(f"path {label}", [g.plan], name, (in_dim, hidden))
            twice(f"path {label} {name} d{in_dim}", kernel, g.plan, xs[0])
        if name == "spmm_fused":
            twice(f"path {label} {name} d{hidden}", kernel, g.plan, feat_of(n, hidden))
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
                f"{label} training", gcn_loss,
                make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss),
                tmodel.params(), g, xs[0], y, {name: 3}, atol_scale=1e-3)
            step_ms, plain_step_ms = time_steps(
                make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss),
                tmodel.params(), g, xs[0], y)
            result.update(train_launches=STEPS * 3, train_step_ms=step_ms,
                          plain_train_step_ms=plain_step_ms, train_peak_gib=peak)
        if then is not None:
            then(g, model, params_np, xs, logits)
        del g, csr
        torch.cuda.empty_cache()
        return result

    def loss_fell(label, losses, final):
        if not final.item() < losses[0].item():
            fail(f"path {label}: the loss after {STEPS} steps ({final.item():.6f}) is not "
                 f"below step 0's ({losses[0].item():.6f})")

    def widths_summary(per_width):
        """ms, plain_ms, library_ms and bound_ms: one call at each of the
        paths' widths, summed; and each width's numbers."""
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
        # the edges' orders by destination and by source (each node's sums in
        # the softmax and the logits' backward), built once per graph
        t0 = time.perf_counter()
        by_rows, by_cols = edge_orders(g)
        torch.cuda.synchronize()
        t_orders = time.perf_counter() - t0
        stats, stats_t = plan_stats(g.plan), plan_stats(g.plan_t)
        bpw = torch.diff(g.plan.block_ptr)
        plane_mib = stats["expanded_slots"] * 4 / 2**20
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: {stats['num_windows']} "
              f"windows, {stats['total_blocks']} blocks for A and {stats_t['total_blocks']} for "
              f"A^T (largest window {int(bpw.max())}, mean {float(bpw.float().mean()):.2f}), "
              f"value plane {plane_mib:.1f} MiB, largest slot {int(g.slots.max())}; "
              f"build_gat_graph {t_build:.2f} s, edge orders by rows and cols {t_orders:.3f} s "
              f"(rows {'sorted' if by_rows.perm is None else 'permuted'}, cols "
              f"{'sorted' if by_cols.perm is None else 'permuted'}), host peak RSS "
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

        # layer 2's scores within rounding of leaky_relu's kink, and the edges
        # whose score has another sign on the kernel path than on the plain
        # path (layer 1's scores come from the same dense products on both);
        # each flip moves step 0's gradients by about one edge's share
        with torch.no_grad():
            x, raw = xs[0], []
            for impl in ("auto", "reference"):
                with deterministic() if impl == "reference" else contextlib.nullcontext():
                    h2 = F.elu(torch.cat([gat_attention_aggregate(
                        g, x @ model.w1[hh], model.a1_src[hh], model.a1_dst[hh], impl=impl)
                        for hh in range(heads)], dim=1)) @ model.w2
                raw.append((h2 @ model.a2_src).double()[g.rows]
                           + (h2 @ model.a2_dst).double()[g.cols])
            near = int((raw[1].abs() < 1e-5).sum())
            flips = int(((raw[0] > 0) != (raw[1] > 0)).sum())
            del raw, h2
        print(f"  layer-2 scores within rounding of leaky_relu's kink (|s + t| < 1e-5): {near}; "
              f"edges whose kernel-path and plain-path scores differ in sign: {flips}")

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
            twice(f"path {label} K4 d{d}", k4[0], wplan, feat)
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
            twice(f"path {label} K5 d{d}", lambda p, f, grad=grad: k5[0](p, f, grad), wplan, feat)
        with torch.no_grad():  # A^T's plane, which the feature gradient reads
            plane_t = torch.zeros(g.plan_t.total_blocks * H * K, device=dev).index_add_(
                0, g.slots_t, alpha)
            wplan_t = dataclasses.replace(g.plan_t, values=plane_t.view(-1, H, K))
            compare("spmm_weighted", f"path {label} K4 on A^T d{classes} (float32 summation "
                    "bound)", wplan_t, (feat,), deg)
        twice(f"path {label} K4 on A^T d{classes}", k4[0], wplan_t, feat)
        walk = block_spmm.plan_walk(wplan, "spmm_dvalues")
        print(f"  path {label} K5 work list of A (PIECE_BLOCKS "
              f"{block_spmm.PIECE_BLOCKS['spmm_dvalues']}, no workspace): "
              f"{walk.tasks.shape[0]} pieces, {walk.cut_windows} windows cut")
        for side, p in (("A", wplan), ("A^T", wplan_t)):
            walk = block_spmm.plan_walk(p, "spmm_weighted")
            most = int(walk.merges[:, 3].max()) if walk.merges.numel() else 1
            print(f"  path {label} K4 work list of {side} (PIECE_BLOCKS "
                  f"{block_spmm.PIECE_BLOCKS['spmm_weighted']}): {walk.tasks.shape[0]} pieces, "
                  f"{walk.cut_windows} windows cut (most pieces {most}); workspace "
                  + ", ".join(f"{walk.slots * walk.rows * d * 4 / 2**20:.2f} MiB at d {d}"
                              for d in (hidden, classes)))
        del wplan, plane, wplan_t, plane_t, csr_w, csr_1
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
        # atol 5e-5 x max|grad|: a1_src's gradient sums edge terms that cancel
        # (a softmax is blind to a shift of a row's logits), so its error is
        # set by the terms; python3 -m voltrix_spmm_tpu_torch.tools.grad_spread
        # needed up to 1.3e-5 (kernel path) and 1.5e-5 (plain path against
        # itself) at these shapes while both summed with float atomics, and
        # one run of this check 2.1e-5
        losses, train_counts, final, peak = train(
            f"{label} training", gat_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_loss),
            tmodel.params(), g, xs[0], y,
            {"spmm_weighted": 2 * per_request, "spmm_dvalues": per_request}, atol_scale=5e-5)
        loss_fell(label, losses, final)
        # step 0's gradients on the kernel path, twice from the same parameters
        p0 = GAT.from_params(gat_params_from_jax(params_np, dev)).params()

        def kernel_grads():
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
            loss = gat_loss(leaves, g, xs[0], y)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        first, again = kernel_grads(), kernel_grads()
        same = all(torch.equal(first[k], again[k]) for k in first)
        print(f"  step 0's kernel-path gradients twice: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of step 0 on the kernel path give different gradients")
        del p0, first, again
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_loss),
            tmodel.params(), g, xs[0], y)
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

    def time_ell(label, wplan, feat, grad, csr_w, csr_1, nnz, per_width, deg):
        """K6 on `wplan` and `feat`, and K7 on (feat, grad), against their
        plain versions at the path's width (K6 under the float32 summation
        bound of rows of degree `deg`; K7 sums d terms); each timed in
        turns with its plain version and its library call
        (torch.sparse.mm on the weighted CSR `csr_w`, sampled_addmm on the
        pattern `csr_1`), with its bound."""
        n, d = wplan.num_nodes, feat.shape[1]
        compare("spmm_ell", f"path {label} K6 d{d} (float32 summation bound)", wplan, (feat,),
                deg)
        compare("spmm_ell_dvals", f"path {label} K7 d{d}", wplan, (feat, grad))
        k6, k7 = kernels["spmm_ell"][:2], kernels["spmm_ell_dvals"][:2]
        rows = ell.plan_rows(wplan)
        lanes = (rows.items[:, 2] - rows.items[:, 1]).float()
        print(f"  K6 row order (PIECE_LANES {ell.PIECE_LANES}): {rows.items.shape[0]} pieces, "
              f"{rows.merges.shape[0]} rows cut (most pieces "
              f"{int(rows.merges[:, 2].max()) if rows.merges.numel() else 1}), heaviest piece "
              f"{int(lanes.max())} lanes against a mean of {float(lanes.mean()):.1f}; workspace "
              f"{rows.slots * d * 4 / 2**20:.2f} MiB at d {d}")
        whole = k6[0](wplan, feat)
        same = torch.equal(whole, k6[0](wplan, feat))
        print(f"  spmm_ell twice at d{d}: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of K6 on the same input differ at d {d}")
        same = torch.equal(spmm_ell_streamed(wplan, feat, num_chunks=4), whole)
        print(f"  spmm_ell_streamed on 4 window chunks at d{d}: "
              f"{'bit-identical to the whole plan' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: K6 on window chunks differs from the whole plan at d {d}")
        k_ms, p_ms, turns = in_turns(torch, lambda: k6[0](wplan, feat), lambda: k6[1](wplan, feat))
        lib = library_ms(lambda: torch.sparse.mm(csr_w, feat))
        # reads hind, erow and vals, feat once; writes out once
        b_ms, b_by = bound_ms(tensor_bytes(wplan.hind, wplan.erow, wplan.vals) + 2 * n * d * 4,
                              2 * nnz * d)
        per_width["spmm_ell"][d] = (k_ms, p_ms, lib, b_ms, b_by)
        print(f"  K6 d={d}: spmm_ell {turns[1]:.4f} / {turns[2]:.4f} ms, plain {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        twice(f"path {label} spmm_ell_dvals d{d}", lambda p, f: k7[0](p, f, grad), wplan, feat)
        k_ms, p_ms, turns = in_turns(torch, lambda: k7[0](wplan, feat, grad),
                                     lambda: k7[1](wplan, feat, grad))
        feat_t = feat.t().contiguous()
        lib = library_ms(lambda: torch.sparse.sampled_addmm(csr_1, grad, feat_t, beta=0.0))
        # reads hind, erow, window_of_block, g and feat once; writes the lanes once
        b_ms, b_by = bound_ms(
            tensor_bytes(wplan.hind, wplan.erow, wplan.window_of_block) + 2 * n * d * 4
            + wplan.erow.numel() * 4, 2 * nnz * d)
        per_width["spmm_ell_dvals"][d] = (k_ms, p_ms, lib, b_ms, b_by)
        print(f"  K7 d={d}: spmm_ell_dvals {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.sampled_addmm {lib:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")

    def gat_ell_path(label, a, cfg, widths, heads):
        """Path E: dot-product GAT on ELL plans of `a`, serving (K6 and K7)
        and training (K6 and K7)."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_ell_graph(a.indptr, a.indices, n, cfg, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        st, st_t = ell_stats(g.plan), ell_stats(g.plan_t)
        bpw = torch.diff(g.plan.block_ptr)
        print(f"path {label}: {n} nodes, {st['nnz']} nnz, {cfg}: {st['num_windows']} windows, "
              f"{st['total_blocks']} blocks for A and {st_t['total_blocks']} for A^T (largest "
              f"window {int(bpw.max())}), {st['lane_slots']} lane slots (fill "
              f"{st['lane_fill']:.4f}, {st['value_bytes_per_edge']:.3f} value bytes per edge, "
              f"{st['lane_slots'] * 4 / 2**20:.2f} MiB per lane array); build_ell_graph "
              f"{t_build:.2f} s, host peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        if not (g.plan.hind.is_cuda and g.plan_t.lane_edge.is_cuda and g.rows.is_cuda):
            fail(f"path {label}: the graph is not on the card before the first request")

        prng = np.random.default_rng(2)  # init_gat_dot's layouts and scales
        h2 = heads * hidden
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((h2, classes)) * (2.0 / h2) ** 0.5
                          for k in ("wq2", "wk2", "wv2")})
        model = GATDot.from_params(gat_dot_params_from_jax(params_np, dev)).eval()
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
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {serve_counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls,
                     {"spmm_ell": per_request * REQUESTS, "spmm_ell_dvals": per_request * REQUESTS})
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

        # scores within rounding of leaky_relu's kink, and the edges whose
        # score has another sign on the kernel path than on the plain path
        # (layer 1: K7 against the plain SDDMM on the same q and k; layer 2:
        # each path's q and k, products in float64); each flip moves step
        # 0's gradients by about one edge's share
        with torch.no_grad():
            x, p = xs[0], model.params()
            near, flips, hs = [0, 0], [0, 0], {}
            for impl in ("auto", "reference"):
                with deterministic() if impl == "reference" else contextlib.nullcontext():
                    hs[impl] = F.elu(torch.cat([dot_attention_aggregate(
                        g, x @ p["wq1"][hh], x @ p["wk1"][hh], x @ p["wv1"][hh], impl=impl)
                        for hh in range(heads)], dim=1))
            for hh in range(heads):
                q, k = x @ p["wq1"][hh], x @ p["wk1"][hh]
                e_k, e_p = (sddmm_ell_ad(g.plan, g.plan_t, q, k, impl=impl)
                            for impl in ("auto", "reference"))
                near[0] += int((e_p.abs() < 1e-6).sum())
                flips[0] += int(((e_k > 0) != (e_p > 0)).sum())
            raw = [(hs[impl] @ p["wq2"]).double()[g.rows] * (hs[impl] @ p["wk2"]).double()[g.cols]
                   for impl in ("auto", "reference")]
            raw = [r.sum(-1) for r in raw]
            near[1] = int((raw[1].abs() < 1e-5).sum())
            flips[1] = int(((raw[0] > 0) != (raw[1] > 0)).sum())
            del hs, raw
        print(f"  scores within rounding of leaky_relu's kink (layer 1 |e| < 1e-6, layer 2 "
              f"|q.k| < 1e-5): {near[0]} and {near[1]}; edges whose kernel-path and plain-path "
              f"scores differ in sign: {flips[0]} in layer 1, {flips[1]} in layer 2")

        # the kernels at the path's widths, on head 0's attention
        with torch.no_grad():
            x = xs[0]
            q, k, v = ((x @ model.params()[w][0]).contiguous() for w in ("wq1", "wk1", "wv1"))
            e = sddmm_ell(g.plan, q, k, per_edge=True) / hidden ** 0.5
            alpha = edge_softmax(g, F.leaky_relu(e, 0.2))
            wplan = dataclasses.replace(g.plan, vals=lane_values(g.plan, alpha))
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr_w, csr_1 = csr_tensor(torch, a, dev, alpha), csr_tensor(torch, a, dev)
        per_width = {"spmm_ell": {}, "spmm_ell_dvals": {}}
        for d in (hidden, classes):
            feat = v if d == hidden else feat_of(n, d)
            time_ell(label, wplan, feat, feat_of(n, d), csr_w, csr_1, a.nnz, per_width, deg)
        del wplan, csr_w, csr_1
        with torch.no_grad():
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (dot-product GAT forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat_dot.py:88) "
              "on labels from the seed")
        tmodel = GATDot.from_params(gat_dot_params_from_jax(params_np, dev))
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
        losses, train_counts, final, peak = train(
            f"{label} training", gat_dot_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_dot_loss),
            tmodel.params(), g, xs[0], y,
            {"spmm_ell": 4 * per_request, "spmm_ell_dvals": 2 * per_request}, atol_scale=1e-5)
        loss_fell(label, losses, final)
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_dot_loss),
            tmodel.params(), g, xs[0], y)
        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        del g
        torch.cuda.empty_cache()
        return {name: {"launches": serve_counts[name], "train_launches": train_counts[name],
                       **common, "per_width": per_width[name]}
                for name in ("spmm_ell", "spmm_ell_dvals")}

    def mh_pieces(plan, d, heads):
        """What K13's work list gives `plan`, in the form of attn_pieces."""
        name = "spmm_attention_mh"
        st = attention.attention_walk_stats(plan, name, d, heads)
        most = int(torch.bincount(attention.attention_walk(plan, name).tasks[:, 0].long()).max())
        return (f"K13's work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS[name]}, PIECE_WORK "
                f"{block_spmm.PIECE_WORK[name]}, head group "
                f"{attention_mh.mh_geometry(heads, d)[0]} of HEAD_GROUP "
                f"{attention_mh.HEAD_GROUP}): {st['pieces']} pieces, {st['cut_windows']} "
                f"windows cut, at most {most} in one window, heaviest {st['max_task_work']} units "
                f"of work against a mean of {st['mean_task_work']:.1f}, workspace "
                f"{st['workspace_mib']:.2f} MiB at H {heads} x d {d}")

    def time_attn(label, plan, q, k, v, g, pdt, per_width):
        """K13, K14 and K15 at one of path G's layers (q, k, v as the model
        projects them, dO): held against their plain versions, K13 twice on
        one input, timed in turns with them, and each kernel's bound from
        this problem's edges; K13 also after head-major copies of q, k and
        v made in the call (what reading through strides saves). K14 and
        K15 take head-major copies made beforehand, as they copy their
        inputs. Returns the time of the copies and K13 on them."""
        heads, n, dk = q.shape
        dv = v.shape[2]
        tag = f"H{heads} d{dk}"
        print(f"  kernels at {tag}/{dv}: {mh_pieces(plan, dv, heads)}")
        attn_compare(f"path {label} {tag}", plan, plan, q, k, v, g, 0.2, pdt)
        scale = 1.0 / dk ** 0.5
        kw = dict(negative_slope=0.2, plane_dtype=pdt)
        with torch.no_grad():
            out, lse = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
            d_row = (g * out).sum(-1)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        bwd = (qc, kc, vc, g, lse, d_row)
        plane = 2 if pdt is not None else 4
        plan_bytes = tensor_bytes(plan.bitmask, plan.hind, plan.window_of_block, plan.block_ptr)
        edges = plan.num_edges * heads
        hn = heads * n
        fns = {
            # reads the plan, q, k and v once; writes out and lse once
            "attn_mh_fwd": (lambda: spmm_attention_mh(plan, q, k, v, **kw),
                            lambda: spmm_attention_mh_reference(plan, q, k, v, **kw),
                            plan_bytes + hn * (4 * dk + plane * (dk + dv) + 4 * dv)
                            + lse.numel() * 4, edges * 2 * (dk + dv)),
            # reads the plan, q, k, v, dO, lse and D once; writes dq once
            "attn_mh_dq": (lambda: attention_mh_dq(plan, *bwd, scale=scale, **kw),
                           lambda: attention_mh_dq_reference(plan, *bwd, scale=scale, **kw),
                           plan_bytes + hn * (4 * dk + plane * (dk + dv) + 4 * dv + 4 + 4 * dk)
                           + lse.numel() * 4, edges * (4 * dk + 2 * dv)),
            # reads the plan, q, k, v, dO (all in the plane dtype), lse and D
            # once; writes dk and dv once
            "attn_mh_dkv": (lambda: attention_mh_dkv(plan, *bwd, scale=scale, **kw),
                            lambda: attention_mh_dkv_reference(plan, *bwd, scale=scale, **kw),
                            plan_bytes + hn * (plane * 2 * (dk + dv) + 4 + 4 * (dk + dv))
                            + lse.numel() * 4, edges * 4 * (dk + dv)),
        }
        for name, (kernel, plain, nbytes, flops) in fns.items():
            k_ms, p_ms, turns = in_turns(torch, kernel, plain)
            b_ms, b_by = bound_ms(nbytes, flops)
            per_width[name][f"h{heads}_d{dk}"] = (k_ms, p_ms, None, b_ms, b_by)
            print(f"  {name} {tag}: kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, no library call, bound {b_ms:.4f} ms "
                  f"({b_by})")
        # the alternative to reading through strides: head-major copies made
        # in the call, as K13's launcher made them before
        strided_ms, copies_ms, turns = in_turns(
            torch, fns["attn_mh_fwd"][0],
            lambda: spmm_attention_mh(plan, q.contiguous(), k.contiguous(), v.contiguous(), **kw),
            plain_iters=20)
        print(f"  attn_mh_fwd {tag}: K13 on the model's projections {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms, head-major copies of them and K13 on those {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms")
        return copies_ms

    def gat_flash_path(label, a, cfg, widths, heads):
        """Path G: flash GAT on the binary plan of `a`, serving (K13) and
        training (K13, K14 and K15)."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        stats = plan_stats(g.plan)
        bpw = torch.diff(g.plan.block_ptr)
        pdt = torch.bfloat16 if n >= 65536 else None  # models/gat_flash.py's rule
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: {stats['num_windows']} "
              f"windows, {stats['total_blocks']} blocks (largest window {int(bpw.max())}, mean "
              f"{float(bpw.float().mean()):.2f}), fill {stats['fill_ratio']:.5f}, bitmask "
              f"{g.plan.bitmask.numel() * 4 / 2**20:.1f} MiB, planes "
              f"{'bf16' if pdt is not None else 'f32'}; build_graph {t_build:.2f} s, host peak "
              f"RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        if not (g.plan.bitmask.is_cuda and g.plan_t is g.plan):
            fail(f"path {label}: the plan is not on the card before the first request")

        prng = np.random.default_rng(2)  # init_gat_flash (= init_gat_dot) layouts and scales
        h2 = heads * hidden
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((h2, classes)) * (2.0 / h2) ** 0.5
                          for k in ("wq2", "wk2", "wv2")})
        model = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).eval()
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
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {serve_counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls, {"attn_mh_fwd": 2 * REQUESTS})
        with torch.no_grad():
            same = torch.equal(model(g, xs[0]), logits[0])
        print(f"  request 0's logits again: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of request 0 give different logits")
        # bf16 planes: float32 noise in layer 1's output may move a layer-2
        # input across a bf16 rounding boundary (one bf16 ulp, 2**-8
        # relative), so the two paths agree to the bf16 class (JAX's own bf16
        # plane tolerance, tests/test_attention.py:468-470); the same model
        # with float32 planes is held at the float32 tolerance
        g32 = (g.plan, g.plan_t, torch.float32)
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(g, x, impl="reference")
                out32, ref32 = model(g32, x), model(g32, x, impl="reference")
                torch.cuda.synchronize()
                diff = calc_diff(out, ref)
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and diff < 1e-4 and torch.allclose(out, ref, rtol=2e-2, atol=2e-2)
                      and torch.allclose(out32, ref32, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, bf16 planes: calc_diff "
                      f"{diff:.3e}, max|kernel - plain| {(out - ref).abs().max().item():.3e}; "
                      f"float32 planes: max|kernel - plain| "
                      f"{(out32 - ref32).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")

        # the kernels at the path's two layers, on request 0's activations
        per_width = {"attn_mh_fwd": {}, "attn_mh_dq": {}, "attn_mh_dkv": {}}
        p = model.params()
        with torch.no_grad():
            x = xs[0]
            # the layouts the model passes: node-major projections, viewed (H, n, d)
            q1, k1, v1 = (_project_heads(x, p[w]) for w in ("wq1", "wk1", "wv1"))
            heads1 = spmm_attention_mh(g.plan, q1, k1, v1, negative_slope=0.2, plane_dtype=pdt)
            h = F.elu(heads1.permute(1, 0, 2).reshape(n, -1))
            q2, k2, v2 = ((h @ p[w])[None] for w in ("wq2", "wk2", "wv2"))
        copies_ms = {
            "h8_d8": time_attn(label, g.plan, q1, k1, v1,
                               feat_of(heads * n, hidden).view(heads, n, hidden), pdt, per_width),
            "h1_d40": time_attn(label, g.plan, q2, k2, v2, feat_of(n, classes)[None], pdt,
                                per_width)}
        del q1, k1, v1, heads1, h, q2, k2, v2
        with torch.no_grad():
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (flash GAT forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat_dot.py:88) "
              "on labels from the seed")
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)

        def grads_of(impl):
            leaves = {k: v.requires_grad_(True)
                      for k, v in gat_flash_params_from_jax(params_np, dev).items()}
            loss = gat_flash_loss(leaves, g32, xs[0], y, impl=impl)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))

        (loss_k, grads_k), (loss_p, grads_p) = grads_of("auto"), grads_of("reference")
        # atol 1e-4 x max|grad|: a hub row's dq sums ~38k terms whose
        # coefficients ds add up to 0 by construction (D = sum p dP), so
        # float32 rounding in another order is large against dq itself
        # (3.3e-5 x max|grad| on wq1 in one run of this script)
        ok, diff, rel = grads_close(torch, calc_diff, grads_k, grads_p, 1e-4)
        ok = ok and torch.allclose(loss_k, loss_p, rtol=1e-4, atol=0.0)
        print(f"  step-0 gradients with float32 planes against the plain path: loss "
              f"{loss_k.item():.6f} / {loss_p.item():.6f}, worst calc_diff {diff:.3e}, worst "
              f"max|diff|/max|grad| {rel:.3e} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label}: float32-plane gradients disagree with the plain path")
        tmodel = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev))
        # bf16 planes, the path's own: the bf16 class, as for the logits
        losses, train_counts, final, peak = train(
            f"{label} training", gat_flash_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), g, xs[0], y,
            {"attn_mh_fwd": 2, "attn_mh_dq": 2, "attn_mh_dkv": 2}, atol_scale=1e-2,
            max_diff=1e-4, rtol=2e-2)
        loss_fell(label, losses, final)
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), g, xs[0], y)
        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        del g
        torch.cuda.empty_cache()
        results = {}
        for name, per in per_width.items():
            serve = serve_counts[name]
            counts = ({"launches": serve, "train_launches": train_counts[name]} if serve else
                      {"launches": train_counts[name], "serve_launches": 0})
            widest = max(per.values(), key=lambda t: t[3])
            results[name] = {**counts, **common,
                             "ms": sum(t[0] for t in per.values()),
                             "plain_ms": sum(t[1] for t in per.values()),
                             "library_ms": None,
                             "bound_ms": sum(t[3] for t in per.values()),
                             "bound_by": widest[4]}
            for tag, (k_ms, p_ms, _, b_ms, _) in per.items():
                results[name].update({f"ms_{tag}": k_ms, f"plain_ms_{tag}": p_ms,
                                      f"bound_ms_{tag}": b_ms})
        results["attn_mh_fwd"].update({f"copies_and_k13_ms_{tag}": t
                                       for tag, t in copies_ms.items()})
        return results

    def time_attn1(label, plan, q, k, v, g, per_width):
        """K9, K10, K11 and K12 at one of path H's layers (one head: q, k, v,
        dO): held against their plain versions, K9 and K10 twice on one input,
        timed in turns with their plain versions, each kernel's bound from
        this problem's edges; K9 beside K13 at one head (K13's walk with a
        group of one head on float32 planes), K10 (with its fixed-order sum,
        as the step runs it) beside K10's lane planes and scatter_lanes
        (index_add_) on them."""
        n, dk = q.shape
        dv = v.shape[1]
        tag = f"d{dk}"
        print(f"  kernels at one head of width {dk}/{dv}: {attn_pieces(plan, dv)}")
        attn1_compare(f"path {label} {tag}", plan, plan, q, k, v, g, 0.2)
        attn_twice(f"path {label} {tag}", plan, q, k, v, g)
        kw = dict(scale=1.0 / dk ** 0.5, negative_slope=0.2)
        with torch.no_grad():
            out, lse = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
            bwd = (q, k, v, g, lse, (g * out).sum(-1))
            _, dk_lane, dv_lane = attention_bwd(plan, q, k, v, out, lse, g, **kw)
        plan_bytes = tensor_bytes(plan.bitmask, plan.hind, plan.window_of_block, plan.block_ptr)
        edges, lanes = plan.num_edges, plan.total_blocks * plan.config.block_w

        def plain_bwd():
            dq, dkl, dvl = attention_bwd_reference(plan, q, k, v, out, lse, g, **kw)
            return dq, scatter_lanes(plan, dkl, n), scatter_lanes(plan, dvl, n)

        fns = {
            # reads the plan, q, k and v once; writes out and lse once
            "attn_fwd": (lambda: spmm_attention(plan, q, k, v, negative_slope=0.2),
                         lambda: spmm_attention_reference(plan, q, k, v, negative_slope=0.2),
                         plan_bytes + n * 4 * (2 * dk + 2 * dv) + lse.numel() * 4,
                         edges * 2 * (dk + dv)),
            # K10 and its fixed-order sum: reads the plan, q, k, v, out, dO and
            # lse once; writes dq, dk and dv once
            "attn_bwd": (lambda: attention_bwd_summed(plan, q, k, v, out, lse, g, **kw),
                         plain_bwd,
                         plan_bytes + n * 4 * (3 * dk + 3 * dv) + lse.numel() * 4
                         + n * 4 * (dk + dv), edges * (6 * dk + 4 * dv) + 2 * n * dv),
            # reads the plan, q, k, v, dO, lse and D once; writes dq once
            "attn_dq": (lambda: attention_dq(plan, *bwd, **kw),
                        lambda: attention_dq_reference(plan, *bwd, **kw),
                        plan_bytes + n * 4 * (3 * dk + 2 * dv + 1) + lse.numel() * 4,
                        edges * (4 * dk + 2 * dv)),
            # reads the plan, q, k, v, dO, lse and D once; writes dk and dv once
            "attn_dkv": (lambda: attention_dkv(plan, *bwd, **kw),
                         lambda: attention_dkv_reference(plan, *bwd, **kw),
                         plan_bytes + n * 4 * (3 * dk + 3 * dv + 1) + lse.numel() * 4,
                         edges * 4 * (dk + dv)),
        }
        for name, (kernel, plain, nbytes, flops) in fns.items():
            k_ms, p_ms, turns = in_turns(torch, kernel, plain)
            b_ms, b_by = bound_ms(nbytes, flops)
            per_width[name][tag] = (k_ms, p_ms, None, b_ms, b_by)
            print(f"  {name} {tag}: kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, no library call, bound {b_ms:.4f} ms "
                  f"({b_by})")
        # K9 beside K13 at one head, in turns
        new_ms, k13_ms, turns = in_turns(
            torch, fns["attn_fwd"][0],
            lambda: spmm_attention_mh(plan, q[None], k[None], v[None], negative_slope=0.2),
            plain_iters=20)
        print(f"  attn_fwd {tag}: K9 {turns[1]:.4f} / {turns[2]:.4f} ms against K13 at one head "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms")
        lanes_ms = cuda_ms(torch, lambda: attention_bwd(plan, q, k, v, out, lse, g, **kw))
        s_ms = cuda_ms(torch, lambda: (scatter_lanes(plan, dk_lane, n),
                                       scatter_lanes(plan, dv_lane, n)))
        s_bound, s_by = bound_ms(lanes * 4 * (dk + dv + 2) + n * 4 * (dk + dv), lanes * (dk + dv))
        per_width["scatter"][tag] = (s_ms, s_bound, k13_ms, lanes_ms)
        print(f"  attn_bwd {tag}: K10 with its fixed-order sum {per_width['attn_bwd'][tag][0]:.4f}"
              f" ms; K10's lane planes {lanes_ms:.4f} ms; scatter_lanes of those planes: "
              f"index_add_ {s_ms:.4f} ms, bound {s_bound:.4f} ms ({s_by}); K11 + K12 "
              f"{per_width['attn_dq'][tag][0] + per_width['attn_dkv'][tag][0]:.4f} ms")

    def flash_head_path(label, a, cfg, widths, heads):
        """Path H: flash GAT on a bare plan of `a`, one head at a time in
        float32: serving (K9) and training (K9 and K10); then the split
        backward (K9, K11 and K12) at both widths."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        plan = csr_preprocess(a.indptr, a.indices, n, cfg).to(dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        lanes = plan.total_blocks * cfg.block_w
        t0 = time.perf_counter()
        held = attention.plan_lane_sources(plan).lane.numel()
        torch.cuda.synchronize()
        t_order = time.perf_counter() - t0
        print(f"path {label}: {n} nodes, {plan.num_edges} edges, {cfg}: {plan.total_blocks} "
              f"blocks, {lanes} lane slots, {held} with bits (K10's slots in the source order "
              f"{held * 4 * 2 * hidden / 1e6:.1f} MB per layer-1 head, "
              f"{held * 4 * 2 * classes / 1e6:.1f} MB at layer 2; the order built in "
              f"{t_order:.2f} s, {(held * 2 + lanes + n + 1) * 4 / 1e6:.1f} MB of int32); "
              f"float32, the per-head path applies no plane rule; csr_preprocess {t_build:.2f} s")
        prng = np.random.default_rng(2)  # G's parameters
        h2 = heads * hidden
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((h2, classes)) * (2.0 / h2) ** 0.5
                          for k in ("wq2", "wk2", "wv2")})
        model = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        per_request = heads + 1

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(plan, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {serve_counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls, {"attn_fwd": per_request * REQUESTS})
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(plan, x, impl="reference")
                torch.cuda.synchronize()
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and torch.allclose(out, ref, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, max|kernel - plain| "
                      f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")

        # the kernels at the path's widths: head 0 of layer 1, and layer 2, on
        # request 0's activations
        per_width = {"attn_fwd": {}, "attn_bwd": {}, "attn_dq": {}, "attn_dkv": {},
                     "scatter": {}}
        p = model.params()
        with torch.no_grad():
            x = xs[0]
            layer1 = [tuple((x @ p[w][hh]).contiguous() for w in ("wq1", "wk1", "wv1"))
                      for hh in range(heads)]
            h = F.elu(torch.cat([spmm_attention(plan, *qkv, negative_slope=0.2)
                                 for qkv in layer1], dim=1))
            layer2 = tuple((h @ p[w]).contiguous() for w in ("wq2", "wk2", "wv2"))
        with torch.no_grad(), deterministic():
            # the plain path's layer-2 q and k, for the scores near the kink
            h_plain = F.elu(torch.cat([spmm_attention_reference(plan, *qkv, negative_slope=0.2)
                                       for qkv in layer1], dim=1))
            rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                           torch.from_numpy(np.diff(a.indptr)).to(dev))
            cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)
            raw = [(q.double()[rows] * k.double()[cols]).sum(-1)
                   for q, k in (layer2[:2], (h_plain @ p["wq2"], h_plain @ p["wk2"]))]
            near = int((raw[1].abs() < 1e-5).sum())
            flips = int(((raw[0] > 0) != (raw[1] > 0)).sum())
            del h_plain, rows, cols, raw
        print(f"  layer-2 scores q.k in float64 from each path's q and k: {near} within 1e-5 of "
              f"leaky_relu's kink; {flips} edges where the kernel path's and the plain path's "
              "differ in sign (each moves step 0's gradients by about one row's share)")
        time_attn1(label, plan, *layer1[0], feat_of(n, hidden), per_width)
        time_attn1(label, plan, *layer2, feat_of(n, classes), per_width)
        with torch.no_grad():
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(plan, x), lambda: model(plan, x, impl="reference"))
        print(f"  request (per-head flash GAT forward): kernel path {req_ms:.4f} ms "
              f"({turns[1]:.4f} / {turns[2]:.4f}), plain path {plain_req_ms:.4f} ms "
              f"({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(plan, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat_dot.py:88) "
              "on labels from the seed")
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
        tmodel = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev))
        # atol 1e-4 x max|grad|: G's float32 rule (a hub row's dq sums ~38k
        # terms whose coefficients add up to 0)
        losses, train_counts, final, peak = train(
            f"{label} training", gat_flash_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), plan, xs[0], y,
            {"attn_fwd": per_request, "attn_bwd": per_request}, atol_scale=1e-4)
        loss_fell(label, losses, final)
        # step 0's gradients on the kernel path, twice from the same parameters
        p0 = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).params()

        def kernel_grads():
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
            loss = gat_flash_loss(leaves, plan, xs[0], y)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        first, again = kernel_grads(), kernel_grads()
        same = all(torch.equal(first[k], again[k]) for k in first)
        print(f"  step 0's kernel-path gradients twice: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of step 0 on the kernel path give different gradients")
        del p0, first, again
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), plan, xs[0], y)

        print(f"path {label}, the split backward: spmm_attention_ad(plan, q, k, v, "
              "plan_t=plan) at a layer-1 head and at layer 2, against the plain split backward "
              "and K10's")

        def grads(qkv, w, plan_t, impl="auto"):
            leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
            out = spmm_attention_ad(plan, *leaves, plan_t=plan_t, negative_slope=0.2, impl=impl)
            (out * w).sum().backward()
            return dict(zip(("q", "k", "v"), (t.grad for t in leaves)))

        ws = [feat_of(n, layer[2].shape[1]) for layer in (layer1[0], layer2)]
        reset_counts()
        split = [grads(layer, w, plan) for layer, w in zip((layer1[0], layer2), ws)]
        torch.cuda.synchronize()
        split_counts, plain_calls = read_counts()
        print(f"  split backward at d {hidden} and d {classes}: launches {split_counts}, plain "
              f"calls {plain_calls}")
        check_counts(f"{label} split backward", split_counts, plain_calls,
                     {"attn_fwd": 2, "attn_dq": 2, "attn_dkv": 2})
        for layer, w, got in zip((layer1[0], layer2), ws, split):
            d = layer[0].shape[1]
            for what, want in (("the plain split backward", grads(layer, w, plan, "reference")),
                               ("K10 and scatter_lanes", grads(layer, w, None))):
                ok, diff, rel = grads_close(torch, calc_diff, got, want, 1e-4)
                print(f"  d {d}: split gradients against {what}: worst calc_diff {diff:.3e}, "
                      f"worst max|diff|/max|grad| {rel:.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label}: the split backward at d {d} disagrees with {what}")
        del plan
        torch.cuda.empty_cache()

        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        counts = {
            "attn_fwd": {"launches": serve_counts["attn_fwd"],
                         "train_launches": train_counts["attn_fwd"],
                         "split_launches": split_counts["attn_fwd"], **common},
            "attn_bwd": {"launches": train_counts["attn_bwd"], "serve_launches": 0, **common},
            "attn_dq": {"launches": split_counts["attn_dq"], "serve_launches": 0,
                        "train_launches": 0},
            "attn_dkv": {"launches": split_counts["attn_dkv"], "serve_launches": 0,
                         "train_launches": 0},
        }
        results = {}
        for name, c in counts.items():
            per = per_width[name]
            widest = max(per.values(), key=lambda t: t[3])
            results[name] = {**c, "ms": sum(t[0] for t in per.values()),
                             "plain_ms": sum(t[1] for t in per.values()), "library_ms": None,
                             "bound_ms": sum(t[3] for t in per.values()), "bound_by": widest[4],
                             "note": ("K14's or K15's kernel at H = 1"
                                      if name in ("attn_dq", "attn_dkv") else "its own kernel")}
            for tag, (k_ms, p_ms, _, b_ms, _) in per.items():
                results[name].update({f"ms_{tag}": k_ms, f"plain_ms_{tag}": p_ms,
                                      f"bound_ms_{tag}": b_ms})
        for tag, (s_ms, s_bound, k13_ms, lanes_ms) in per_width["scatter"].items():
            results["attn_bwd"].update({f"scatter_ms_{tag}": s_ms,
                                        f"scatter_bound_ms_{tag}": s_bound,
                                        f"lane_planes_ms_{tag}": lanes_ms})
            results["attn_fwd"][f"k13_one_head_ms_{tag}"] = k13_ms
        return results

    def linkpred_path(label, a, cfg, widths):
        """Path F: GCN link prediction on `a`: K1 for the encoder, K7 for
        the SDDMM scores of the candidate edges, K6 in their backward."""
        in_dim, hidden, emb = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan, plan_t, labels = build_link_candidates(a.indptr, a.indices, n,
                                                     np.random.default_rng(5), neg_ratio=1.0,
                                                     config=cfg, device=dev)
        torch.cuda.synchronize()
        t_cand = time.perf_counter() - t0
        st = ell_stats(plan)
        bpw = torch.diff(plan.block_ptr)
        print(f"path {label}: {n} nodes, {a.nnz} nnz, GCN plan {cfg}: "
              f"{plan_stats(g.plan)['total_blocks']} blocks; {st['nnz']} candidate edges "
              f"({int(labels.sum().item())} of A), ELL {cfg}: {st['num_windows']} windows, "
              f"{st['total_blocks']} blocks (largest window {int(bpw.max())}), fill "
              f"{st['lane_fill']:.4f}; build_graph {t_graph:.2f} s, build_link_candidates "
              f"{t_cand:.2f} s, host peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")

        prng = np.random.default_rng(3)
        params_np = {
            "w1": prng.standard_normal((in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
            "b1": prng.standard_normal(hidden) * 0.1,
            "w2": prng.standard_normal((hidden, emb)) * (2.0 / hidden) ** 0.5,
            "b2": prng.standard_normal(emb) * 0.1,
        }
        model = GCN.from_params(gcn_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()

        def request(x, impl="auto"):
            return link_scores(plan, plan_t, model(g, x, impl=impl), impl=impl)

        reset_counts()
        scores, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                scores.append(request(x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} scoring requests: launches {serve_counts}, plain calls "
              f"{plain_calls}; host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls,
                     {"spmm_block": 2 * REQUESTS, "spmm_ell_dvals": REQUESTS})
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, scores)):
                ref = request(x, "reference")
                torch.cuda.synchronize()
                scale = ref.abs().max().item()
                diff = calc_diff(out, ref)
                ok = (out.shape == ref.shape == (plan.num_edges,)
                      and bool(torch.isfinite(out).all()) and diff < 1e-6
                      and torch.allclose(out, ref, rtol=1e-4, atol=1e-4 * scale))
                extra = ""
                if i == 0:  # AUC sorts 5M scores on the host: request 0 only
                    auc_k, auc_p = link_auc(out, labels), link_auc(ref, labels)
                    ok = ok and abs(auc_k - auc_p) <= 1e-5
                    extra = f", AUC {auc_k:.7f} / plain {auc_p:.7f}"
                print(f"  request {i}: {out.numel()} scores, calc_diff {diff:.3e}, max|kernel - "
                      f"plain| {(out - ref).abs().max().item():.3e} (max|score| {scale:.3e})"
                      f"{extra} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: scores disagree with the plain path")

        # the kernels at the path's width: K7 on the scores, K6 on random cotangents
        with torch.no_grad():
            h = model(g, xs[0]).contiguous()
        cot_np = rng.standard_normal(plan.num_edges).astype(np.float32)
        gplan = dataclasses.replace(plan, vals=lane_values(plan, torch.from_numpy(cot_np).to(dev)))
        H, K = cfg.block_h, cfg.block_w
        lane_edge = plan.lane_edge.cpu().numpy()
        lanes = np.nonzero(lane_edge >= 0)[0]
        rows = (plan.window_of_block.cpu().numpy()[lanes // K].astype(np.int64) * H
                + plan.erow.cpu().numpy().reshape(-1)[lanes])
        cols = plan.hind.cpu().numpy().reshape(-1)[lanes]
        cand = sp.csr_matrix((cot_np[lane_edge[lanes]], (rows, cols)), shape=(n, n))
        cand.sort_indices()
        csr_w = csr_tensor(torch, cand, dev, torch.from_numpy(cand.data))
        csr_1 = csr_tensor(torch, cand, dev)
        deg = torch.from_numpy(np.diff(cand.indptr).astype(np.float32)).to(dev)[:, None]
        per_width = {"spmm_ell": {}, "spmm_ell_dvals": {}}
        time_ell(label, gplan, h, h, csr_w, csr_1, plan.num_edges, per_width, deg)
        del gplan, csr_w, csr_1, cand
        # K1 at the encoder's width, under the float32 summation bound of A's rows
        x, deg_a, csr_a = xs[0], torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(
            dev)[:, None], csr_tensor(torch, a, dev)
        compare("spmm_block", f"path {label} K1 d{in_dim} (float32 summation bound)", g.plan,
                (x,), deg_a)
        piece_line(f"path {label}", [g.plan], "spmm_block", (in_dim,))
        k_ms, p_ms, turns = in_turns(torch, lambda: spmm_block(g.plan, x),
                                     lambda: spmm_reference(g.plan, x))
        lib = library_ms(lambda: torch.sparse.mm(csr_a, x))
        b_ms, b_by = bound_ms(tensor_bytes(g.plan.bitmask, g.plan.hind, g.plan.block_ptr)
                              + 2 * n * in_dim * 4, 2 * a.nnz * in_dim)
        print(f"  K1 d={in_dim}: spmm_block {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        k1_times = {f"f_ms_d{in_dim}": k_ms, f"f_plain_ms_d{in_dim}": p_ms,
                    f"f_library_ms_d{in_dim}": lib, f"f_bound_ms_d{in_dim}": b_ms}
        del csr_a
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(torch, lambda: request(x),
                                                   lambda: request(x, "reference"))
        print(f"  request (GCN forward and scores): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: request(x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3) on the candidates' labels")
        tmodel = GCN.from_params(gcn_params_from_jax(params_np, dev))

        def loss_fn(params, g_, x_, y_, impl="auto"):
            return link_pred_loss(params, g_, plan, plan_t, x_, y_, impl=impl)

        def stepper(optimizer):
            step = make_link_pred_step(optimizer)
            return lambda params, g_, x_, y_, impl="auto": step(params, g_, plan, plan_t, x_, y_,
                                                                impl=impl)

        # atol 1e-3 x max|grad|: the GCN's ReLU, as on path A
        losses, train_counts, final, peak = train(
            f"{label} training", loss_fn,
            stepper(torch.optim.Adam(tmodel.parameters(), lr=5e-3)), tmodel.params(), g, xs[0],
            labels, {"spmm_block": 3, "spmm_ell_dvals": 1, "spmm_ell": 2}, atol_scale=1e-3)
        loss_fell(label, losses, final)
        step_ms, plain_step_ms = time_steps(
            stepper(torch.optim.Adam(tmodel.parameters(), lr=5e-3)), tmodel.params(), g, xs[0],
            labels)
        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        del g, plan, plan_t
        torch.cuda.empty_cache()
        result = {name: {"launches": serve_counts[name], "train_launches": train_counts[name],
                         **common, "per_width": per_width.get(name, {})}
                  for name in ("spmm_ell", "spmm_ell_dvals", "spmm_block")}
        result["spmm_block"].update(k1_times)
        return result

    def sum_bound_ok(got, want, deg, abs_sum):
        """(ok, max|got - want|): |got - want| <= 1e-4 + 1e-5 |want| plus the
        float32 summation bound (deg - 1) 2**-24 sum|a x| once for each side,
        as compare() allows."""
        allow = 1e-4 + 1e-5 * want.abs() + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        diff = (got - want).abs()
        return bool((diff <= allow).all()) and bool(torch.isfinite(got).all()), diff.max().item()

    path_i, path_j = {}, {}

    def int8_path(label, a, g):
        """Path I: REQUESTS calls of spmm(plan, x, impl="int8") at d 128 and at
        d 256 on A's plan (K8 once each); K8 against its plain version under
        the summation bound, against a float64 host product of the same
        bf16-dequantized features (first and last 2,048 rows) and against
        K1's float32 output (relative error < 2e-2, tests/test_quant.py:41);
        K8 timed in turns with its plain version and with K1."""
        plan, n = g.plan, a.shape[0]
        widths = (128, 256)
        xs = {d: [feat_of(n, d) for _ in range(REQUESTS)] for d in widths}
        torch.cuda.synchronize()
        reset_counts()
        outs, wall_ms = {d: [] for d in widths}, []
        for d in widths:
            for x in xs[d]:
                t0 = time.perf_counter()
                outs[d].append(spmm(plan, x, impl="int8"))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"path {label}: {REQUESTS} requests of spmm(plan, x, impl='int8') at each of d "
              f"{widths}: launches {counts}, plain calls {plain_calls}; host ms per request "
              f"{[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {"spmm_int8": len(widths) * REQUESTS})
        path_i["launches"] = counts["spmm_int8"]
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        piece_line(f"path {label}", [plan], "spmm_int8", widths)
        twice(f"path {label} spmm_int8 d128", spmm_int8, plan, xs[128][0])
        rows = np.r_[0:2048, n - 2048:n]
        a_rows = a[rows].astype(np.float64)
        deg_rows = np.diff(a.indptr)[rows][:, None].astype(np.float64)
        per_width = {}
        for d in widths:
            for i, out in enumerate(outs[d]):
                if out.shape != (n, d) or not bool(torch.isfinite(out).all()):
                    fail(f"path {label} d{d} request {i}: output {tuple(out.shape)} is not a "
                         f"finite ({n}, {d})")
            x, out = xs[d][0], outs[d][0]
            compare("spmm_int8", f"path {label} d{d} (float32 summation bound)", plan, (x,), deg)
            q, sc = quant.quantize_padded(x)
            xq = dequantize_rows(q, sc, torch.bfloat16).float()[:, :d].contiguous()
            xq64 = xq.double().cpu().numpy()
            host = a_rows @ xq64
            got = out.cpu().double().numpy()[rows]
            allow = (1e-4 + 1e-5 * np.abs(host)
                     + np.clip(deg_rows - 1, 0, None) * 2.0**-24 * (abs(a_rows) @ np.abs(xq64)))
            host_err = float(np.abs(got - host).max())
            host_ok = bool((np.abs(got - host) <= allow).all())
            rel = relative_error(spmm_block(plan, x), out)
            ok = host_ok and rel < 2e-2
            print(f"  d{d} request 0: against a float64 host product of the bf16-dequantized "
                  f"features ({len(rows)} rows) max|diff| {host_err:.3e}; against K1's float32 "
                  f"output relative error {rel:.3e} (limit 2e-2) -> {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"path {label} d{d}: K8 disagrees with the host product or with K1")
            k_ms, p_ms, turns = in_turns(torch, lambda: quant.launch_quantized(plan, q, sc, d),
                                         lambda: spmm_int8_reference(plan, x))
            w_ms, k1_ms, turns1 = in_turns(torch, lambda: spmm_int8(plan, x),
                                           lambda: spmm_block(plan, x), plain_iters=20)
            q_ms = cuda_ms(torch, lambda: quant.quantize_padded(x))
            lib = library_ms(lambda: torch.sparse.mm(csr, xq))
            # reads the bitmask, hind, the int8 rows and the scales once; writes out
            b_ms, b_by = bound_ms(tensor_bytes(plan.bitmask, plan.hind, q, sc) + n * d * 4,
                                  2 * a.nnz * d)
            per_width[d] = (k_ms, p_ms, lib, b_ms, b_by)
            path_i.update({f"wrapper_ms_d{d}": w_ms, f"k1_ms_d{d}": k1_ms,
                           f"quantize_ms_d{d}": q_ms})
            print(f"  K8 d={d}: kernel alone {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms; spmm_int8 (quantize_rows and K8) "
                  f"{turns1[1]:.4f} / {turns1[2]:.4f} ms against K1 {turns1[0]:.4f} / "
                  f"{turns1[3]:.4f} ms on the same plan; quantize_rows alone {q_ms:.4f} ms; "
                  f"torch.sparse.mm on the dequantized float32 features (dequantization "
                  f"outside the timed call) {lib:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        path_i.update(widths_summary(per_width))
        del csr

    def int8_on_c(label, a, g):
        """K8 at d 256 on path C's coverage plan: against its plain version
        under the summation bound and K3's float32 output (relative error <
        2e-2), timed in turns with its plain version and with K3."""
        plan, n, d = g.plan, a.shape[0], 256
        x = feat_of(n, d)
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        compare("spmm_int8", f"path {label} K8 d{d} (float32 summation bound)", plan, (x,), deg)
        piece_line(f"path {label}", [plan], "spmm_int8", (d,))
        twice(f"path {label} spmm_int8 d{d}", spmm_int8, plan, x)
        rel = relative_error(spmm_fused(plan, x), spmm_int8(plan, x))
        print(f"  K8 d{d} against K3's float32 output: relative error {rel:.3e} (limit 2e-2) -> "
              f"{'ok' if rel < 2e-2 else 'MISMATCH'}")
        if not rel < 2e-2:
            fail(f"path {label}: K8 disagrees with K3")
        q, sc = quant.quantize_padded(x)
        xq = dequantize_rows(q, sc, torch.bfloat16).float()[:, :d].contiguous()
        k_ms, p_ms, turns = in_turns(torch, lambda: quant.launch_quantized(plan, q, sc, d),
                                     lambda: spmm_int8_reference(plan, x), plain_iters=2)
        w_ms, k3_ms, turns1 = in_turns(torch, lambda: spmm_int8(plan, x),
                                       lambda: spmm_fused(plan, x), plain_iters=20)
        csr = csr_tensor(torch, a, dev)
        lib = library_ms(lambda: torch.sparse.mm(csr, xq))
        b_ms, b_by = bound_ms(tensor_bytes(plan.bitmask, plan.hind, q, sc) + n * d * 4,
                              2 * a.nnz * d)
        path_i.update({f"c_ms_d{d}": k_ms, f"c_plain_ms_d{d}": p_ms, f"c_wrapper_ms_d{d}": w_ms,
                       f"c_k3_ms_d{d}": k3_ms, f"c_library_ms_d{d}": lib,
                       f"c_bound_ms_d{d}": b_ms, "c_bound_by": b_by})
        print(f"  K8 d={d} on C's plan: kernel alone {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms; spmm_int8 {turns1[1]:.4f} / {turns1[2]:.4f} "
              f"ms against K3 {turns1[0]:.4f} / {turns1[3]:.4f} ms; torch.sparse.mm on the "
              f"dequantized features {lib:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        del csr

    def streamed_path(label, a, g, model, params_np, xs, logits):
        """Path J.1: A's GCN on A's graph built with stream_chunks=4: REQUESTS
        requests (K1 2 x 4 each) whose logits must equal path A's bit for bit
        (K1 sums each window in the same order on a chunk as on the whole
        plan), step-0 loss and gradients equal to the unstreamed graph's,
        then STEPS SGD steps (K1 3 x 4 each)."""
        n, chunks = a.shape[0], 4
        classes = model.w2.shape[1]
        t0 = time.perf_counter()
        gs = build_graph(a.indptr, a.indices, n, g.plan.config, symmetric=True,
                         stream_chunks=chunks, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if not (isinstance(gs.plan, list) and len(gs.plan) == chunks and gs.plan_t is gs.plan
                and all(s.bitmask.is_cuda for s in gs.plan) and gs.num_nodes == n):
            fail(f"path {label}: build_graph(stream_chunks={chunks}) did not give {chunks} chunks "
                 "on the card")
        print(f"path {label}: build_graph(..., {g.plan.config}, stream_chunks={chunks}) "
              f"{t_build:.2f} s: chunk rows {[s.num_nodes for s in gs.plan]}, blocks "
              f"{[s.total_blocks for s in gs.plan]}")
        piece_line(f"path {label}", gs.plan, "spmm_block", (128, 256))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        outs, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                outs.append(model(gs, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        serve_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; host "
              f"ms per request {[round(t, 3) for t in wall_ms]}; torch.cuda.max_memory_allocated "
              f"{serve_peak:.3f} GiB (A's graph and this one both held)")
        check_counts(label, counts, plain_calls, {"spmm_block": 2 * chunks * REQUESTS})
        same = [torch.equal(o, w) for o, w in zip(outs, logits)]
        print(f"  logits against path A's unstreamed requests: bit-identical {same}")
        if not all(same):
            fail(f"path {label}: streamed logits differ from path A's")
        y = torch.from_numpy(np.random.default_rng(3).integers(0, classes, n)).to(dev)

        def step0(graph):
            leaves = {k: v.requires_grad_(True)
                      for k, v in gcn_params_from_jax(params_np, dev).items()}
            loss = gcn_loss(leaves, graph, xs[0], y)
            return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        (loss_s, grads_s), (loss_w, grads_w) = step0(gs), step0(g)
        equal = torch.equal(loss_s, loss_w) and all(torch.equal(grads_s[k], grads_w[k])
                                                    for k in grads_w)
        print(f"  step-0 loss and gradients against the unstreamed graph: "
              f"{'bit-identical' if equal else 'DIFFERENT'} (max|diff| "
              f"{max((grads_s[k] - grads_w[k]).abs().max().item() for k in grads_w):.3e})")
        if not equal:
            fail(f"path {label}: streamed step-0 gradients differ from the unstreamed graph's")
        tmodel = GCN.from_params(gcn_params_from_jax(params_np, dev))
        _, train_counts, _, peak = train(
            f"{label} training", gcn_loss,
            make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss),
            tmodel.params(), gs, xs[0], y, {"spmm_block": 3 * chunks}, atol_scale=1e-3)
        with torch.no_grad():
            x = xs[0]
            s_ms, w_ms, turns = in_turns(torch, lambda: model(gs, x), lambda: model(g, x),
                                         plain_iters=20)
        print(f"  request: streamed {turns[1]:.4f} / {turns[2]:.4f} ms, unstreamed (path A's "
              f"graph) {turns[0]:.4f} / {turns[3]:.4f} ms")
        step = make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss)
        st_ms, sw_ms, turns = in_turns(torch, lambda: step(tmodel.params(), gs, xs[0], y),
                                       lambda: step(tmodel.params(), g, xs[0], y),
                                       plain_iters=20)
        print(f"  training step: streamed {turns[1]:.4f} / {turns[2]:.4f} ms, unstreamed "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(gs, x)), "request", top=8)
        path_j.update(j_stream_launches=counts["spmm_block"],
                      j_stream_train_launches=train_counts["spmm_block"],
                      j_stream_request_ms=s_ms, j_unstreamed_request_ms=w_ms,
                      j_stream_train_step_ms=st_ms, j_unstreamed_train_step_ms=sw_ms,
                      j_stream_serve_peak_gib=serve_peak, j_stream_train_peak_gib=peak)
        del gs

    def hybrid_path(label, a, g):
        """Path J.2: the JAX package's default hybrid plan of A's CSR (dense
        side PlanConfig(128, 128, 8) on K3, sparse side PlanConfig(512, 128,
        1, block_unroll=4) on K1): REQUESTS spmm requests at d 128 and at d 256
        (K3 and K1 once each), against K1 on A's plan and against the plain
        path under the summation bound; spmm_ad's gradient against the plain
        path; timed in turns with K1 on A's plan."""
        n = a.shape[0]
        t0 = time.perf_counter()
        hplan = csr_preprocess_hybrid(a.indptr, a.indices, n).to(dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        st = hybrid_stats(hplan)
        print(f"path {label}: csr_preprocess_hybrid {t_build:.2f} s; dense_frac "
              f"{st['dense_frac']:.4f}, dense {hplan.dense.config}: {st['dense']['total_blocks']} "
              f"blocks, {st['dense']['nnz']} nnz; sparse {hplan.sparse.config}: "
              f"{st['sparse']['total_blocks']} blocks, {st['sparse']['nnz']} nnz; gather rows "
              f"{st['total_gather_rows']} (A's plan {g.plan.gather_rows})")
        if not (hplan.dense.total_blocks and hplan.sparse.total_blocks):
            fail(f"path {label}: a side of the hybrid plan has no blocks")
        widths = (128, 256)
        piece_line(f"path {label} sparse side", [hplan.sparse], "spmm_block", widths)
        piece_line(f"path {label} dense side", [hplan.dense], "spmm_fused", widths)
        xs = {d: [feat_of(n, d) for _ in range(REQUESTS)] for d in widths}
        torch.cuda.synchronize()
        reset_counts()
        outs, wall_ms = {d: [] for d in widths}, []
        for d in widths:
            for x in xs[d]:
                t0 = time.perf_counter()
                outs[d].append(spmm(hplan, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"  {REQUESTS} requests of spmm(hybrid plan, x) at each of d {widths}: launches "
              f"{counts}, plain calls {plain_calls}; host ms per request "
              f"{[round(t, 3) for t in wall_ms]}")
        nreq = len(widths) * REQUESTS
        check_counts(label, counts, plain_calls, {"spmm_fused": nreq, "spmm_block": nreq})
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        dense_a = plan_csr(hplan.dense)
        if dense_a.nnz != hplan.dense.num_edges:
            fail(f"path {label}: the dense side's bits give {dense_a.nnz} edges, not "
                 f"{hplan.dense.num_edges}")
        csr_dense = csr_tensor(torch, dense_a, dev)
        deg_dense = torch.from_numpy(np.diff(dense_a.indptr).astype(np.float32)).to(dev)[:, None]
        for d in widths:
            for i, (x, out) in enumerate(zip(xs[d], outs[d])):
                abs_sum = spmm_reference(g.plan, x.abs())
                for what, want in (("K1 on A's plan", spmm_block(g.plan, x)),
                                   ("the plain path", spmm(hplan, x, impl="reference"))):
                    ok, err = sum_bound_ok(out, want, deg, abs_sum)
                    print(f"  d{d} request {i} against {what}: max|diff| {err:.3e} -> "
                          f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail(f"path {label} d{d} request {i} disagrees with {what}")
            x = xs[d][0]
            # K3 alone on the dense side: against its plain version under the
            # summation bound of the side's rows, twice for the same bits,
            # timed in turns with its plain version, beside torch.sparse.mm on
            # the side's CSR and its bound
            compare("spmm_fused", f"path {label} dense side K3 d{d} (float32 summation bound)",
                    hplan.dense, (x,), deg_dense)
            twice(f"path {label} dense side spmm_fused d{d}", spmm_fused, hplan.dense, x)
            k3_ms, k3_plain_ms, k3_turns = in_turns(
                torch, lambda: spmm_fused(hplan.dense, x),
                lambda: spmm_fused_reference(hplan.dense, x))
            dense_lib = library_ms(lambda: torch.sparse.mm(csr_dense, x))
            b_ms, b_by = bound_ms(tensor_bytes(hplan.dense.bitmask, hplan.dense.hind,
                                               hplan.dense.block_ptr) + 2 * n * d * 4,
                                  2 * hplan.dense.num_edges * d)
            print(f"  K3 d={d} on the dense side: spmm_fused {k3_turns[1]:.4f} / "
                  f"{k3_turns[2]:.4f} ms, plain {k3_turns[0]:.4f} / {k3_turns[3]:.4f} ms, "
                  f"torch.sparse.mm on the side's CSR {dense_lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")
            path_j.update({f"j_hybrid_dense_plain_ms_d{d}": k3_plain_ms,
                           f"j_hybrid_dense_library_ms_d{d}": dense_lib,
                           f"j_hybrid_dense_bound_ms_d{d}": b_ms})
            h_ms, k1_ms, turns = in_turns(torch, lambda: spmm(hplan, x),
                                          lambda: spmm_block(g.plan, x), plain_iters=20)
            dense_ms = cuda_ms(torch, lambda: spmm_fused(hplan.dense, x))
            sparse_ms = cuda_ms(torch, lambda: spmm_block(hplan.sparse, x))
            if d == widths[0]:
                print_profile(*profile_requests(torch, lambda: spmm(hplan, x)), "request", top=6)
            path_j.update({f"j_hybrid_ms_d{d}": h_ms, f"j_k1_ms_d{d}": k1_ms,
                           f"j_hybrid_dense_k3_ms_d{d}": dense_ms,
                           f"j_hybrid_sparse_k1_ms_d{d}": sparse_ms})
            print(f"  d{d}: spmm on the hybrid plan (K3 + K1) {turns[1]:.4f} / {turns[2]:.4f} ms, "
                  f"K1 on A's plan {turns[0]:.4f} / {turns[3]:.4f} ms; the sides alone: K3 on the "
                  f"dense side {dense_ms:.4f} ms, K1 on the sparse side {sparse_ms:.4f} ms")
        x, w = xs[128][0], feat_of(n, 128)

        def grad_of(impl):
            leaf = x.clone().requires_grad_(True)
            (spmm_ad(hplan, hplan, leaf, impl=impl) * w).sum().backward()
            return leaf.grad

        ok, err = sum_bound_ok(grad_of("auto"), grad_of("reference"), deg,
                               spmm_reference(g.plan, w.abs()))
        print(f"  spmm_ad(hybrid plan, hybrid plan, x) gradient against the plain path: "
              f"max|diff| {err:.3e} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label}: the hybrid gradient disagrees with the plain path")
        path_j.update(j_hybrid_launches_k3=counts["spmm_fused"],
                      j_hybrid_launches_k1=counts["spmm_block"], j_hybrid_dense_frac=st["dense_frac"])
        del hplan, csr_dense

    def after_a(g, model, params_np, xs, logits):
        int8_path("I (ogbn-arxiv proxy, int8 SpMM, K8)", arxiv, g)
        streamed_path("J.1 (ogbn-arxiv proxy, streamed GCN, K1 on 4 window chunks)", arxiv, g,
                      model, params_np, xs, logits)
        hybrid_path("J.2 (ogbn-arxiv proxy, hybrid plan, K3 and K1)", arxiv, g)

    t0 = time.perf_counter()
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    print(f"graph: ogbn-arxiv proxy in {time.perf_counter() - t0:.2f} s")
    results = {
        "spmm_block": serve("A (ogbn-arxiv proxy, K1)", arxiv, PlanConfig(128, 128),
                            "spmm_block", (128, 256, 40), train_gcn=True, then=after_a),
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
    # examples/train_gat_dot.py:54's plan geometry
    path_e = gat_ell_path("E (ogbn-arxiv proxy with self-loops, dot-product GAT, K6 and K7)",
                          loops, PlanConfig(128, 128, block_unroll=4), (128, 8, 40), heads=8)
    # the same graph, geometry and widths as E (bench/bm_gat.py:174-177)
    results.update(gat_flash_path(
        "G (ogbn-arxiv proxy with self-loops, flash GAT, K13, K14 and K15)", loops,
        PlanConfig(128, 128, block_unroll=4), (128, 8, 40), heads=8))
    # the same graph, plan geometry and widths as G, on a bare plan
    results.update(flash_head_path(
        "H (ogbn-arxiv proxy with self-loops, per-head flash GAT, K9-K12)", loops,
        PlanConfig(128, 128, block_unroll=4), (128, 8, 40), heads=8))
    del loops
    t0 = time.perf_counter()
    ddi = symmetrize(proxy_csr("ddi", seed=0))
    print(f"graph: ogbl-ddi proxy in {time.perf_counter() - t0:.2f} s")
    path_f = linkpred_path("F (ogbl-ddi proxy, GCN link prediction, K1, K6 and K7)", ddi,
                           PlanConfig(128, 128), (256, 256, 256))
    del ddi
    for name in ("spmm_ell", "spmm_ell_dvals"):
        # E's widths (8, 40) and F's (256) side by side
        per_width = {**path_e[name].pop("per_width"), **path_f[name].pop("per_width")}
        results[name] = {**path_e[name], **{f"f_{k}": v for k, v in path_f[name].items()},
                         **widths_summary(per_width)}
    results["spmm_block"].update(f_launches=path_f["spmm_block"]["launches"],
                                 f_train_launches=path_f["spmm_block"]["train_launches"],
                                 **{k: v for k, v in path_f["spmm_block"].items()
                                    if k.startswith("f_")})
    t0 = time.perf_counter()
    protein = symmetrize(proxy_csr("protein", seed=0))
    n = protein.shape[0]
    print(f"graph: protein proxy in {time.perf_counter() - t0:.2f} s")
    last = (n - 1) // 2048 * 2048
    results["spmm_fused"] = serve(
        "C (protein proxy, K3)", protein,
        PlanConfig(2048, 128, gather_segment=128, block_unroll=4), "spmm_fused",
        (8, 256, 112), host_rows=np.r_[0:2048, last:n],
        then=lambda g, *_: int8_on_c("C (protein proxy)", protein, g))
    results["spmm_int8"] = path_i
    results["spmm_block"].update(
        {k: v for k, v in path_j.items() if k.startswith("j_stream") or k.startswith("j_k1")})
    results["spmm_fused"].update(
        {k: v for k, v in path_j.items() if k.startswith("j_hybrid")})

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
    # ms / plain_ms / library_ms / bound_ms: one call at each of the paths' widths, summed
    # (K6 and K7: E's d 8 and 40 and F's d 256; K13-K15: G's two layers, H 8 x d 8 and
    # H 1 x d 40; K9-K12: path H's, one head of d 8 and d 40); f_*: path F's counts and
    # times
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()

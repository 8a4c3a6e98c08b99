"""The fused-attention kernels against their work split, at the shapes of
chip_smoke.py's paths G and H: the ogbn-arxiv proxy with self-loops,
PlanConfig(128, 128, block_unroll=4).

- `--kernels tasks`: the task size (plan blocks per thread block) and head
  group (heads per thread block) of the entry points that take them
  (ops/_attn_core.py:_TASK_BLOCKS, _HEAD_GROUP). Path G, K14 and K15: bf16
  planes, layer 1 (8 heads of width 8) and layer 2 (1 head of width 40);
  path H, K11 and K12: float32, one head of width 8 (a layer-1 head) and of
  width 40 (layer 2).
- `--kernels spmm_attention_mh`: K13's piece limits
  (ops/block_spmm.py:PIECE_BLOCKS, PIECE_WORK) and head group
  (ops/attention_mh.py:HEAD_GROUP) at path G's two layers, bf16 planes, q,
  k and v the node-major projections the model passes, timed on the whole
  plan and on its hub window alone, with what the work list gives and the
  workspace.
- `--kernels spmm_attention attention_bwd`: the piece limits of K9 and of
  K10 (ops/block_spmm.py:PIECE_BLOCKS, PIECE_WORK; K10 as the training
  step runs it, with its lane planes summed by source,
  `attention_bwd_summed`) at path H's widths 8 and 40, timed on the whole
  plan and on the plan cut to its hub window alone, with what the work
  list gives (pieces, windows cut, the heaviest piece's work against the
  mean, the workspace).

    python3 -m voltrix_spmm_tpu_torch.tools.attn_task_sweep [--kernels ...]

Needs one CUDA device. Each setting is timed twice with CUDA events (mean
of 20 launches after 3 warm-up), the settings in turns: up, then down. q,
k, v and dO are random normal, made from a seed.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import PlanConfig, csr_preprocess
from ..data import proxy_csr, symmetrize
from ..ops import (
    _attn_core,
    attention_bwd_summed,
    attention_mh,
    attention_dkv,
    attention_dq,
    attention_mh_dkv,
    attention_mh_dq,
    block_spmm,
    spmm_attention,
    spmm_attention_mh,
)
from ..ops.attention import attention_walk_stats
from .k6_piece_sweep import cuda_ms
from .spmm_piece_sweep import heaviest_window

TASKS = (1, 2, 4, 8, 16)
GROUPS = (1, 8)
KERNELS = ("tasks", "spmm_attention", "attention_bwd", "spmm_attention_mh")
BLOCKS = (8, 16, 32, 64)  # K9's and K10's PIECE_BLOCKS swept
WORK = (512, 1024, 2048, 4096, None)  # and PIECE_WORK
MH_BLOCKS = (16, 32, 64)  # K13's PIECE_BLOCKS swept
MH_WORK = (256, 512, 1024, 2048)  # its PIECE_WORK
MH_GROUPS = (1, 2, 4, 8)  # its HEAD_GROUP


def _path_g(plan, n, dev, gen):
    kw = dict(negative_slope=0.2, plane_dtype=torch.bfloat16)
    cases = []
    for heads, d in ((8, 8), (1, 40)):
        q, k, v, g = (torch.randn(heads, n, d, device=dev, generator=gen) for _ in range(4))
        out, lse = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
        bwd = (q, k, v, g, lse, (g * out).sum(-1))
        scale = 1.0 / d ** 0.5
        cases += [
            ("attention_mh_dq", heads, d,
             lambda bwd=bwd, s=scale: attention_mh_dq(plan, *bwd, scale=s, **kw)),
            ("attention_mh_dkv", heads, d,
             lambda bwd=bwd, s=scale: attention_mh_dkv(plan, *bwd, scale=s, **kw)),
        ]
    return cases


def _path_h(plan, n, dev, gen):
    cases = []
    for d in (8, 40):
        q, k, v, g = (torch.randn(n, d, device=dev, generator=gen) for _ in range(4))
        out, lse = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
        kw = dict(scale=1.0 / d ** 0.5, negative_slope=0.2)
        bwd = (q, k, v, g, lse, (g * out).sum(-1))
        cases += [
            ("attention_dq", 1, d, lambda bwd=bwd, kw=kw: attention_dq(plan, *bwd, **kw)),
            ("attention_dkv", 1, d, lambda bwd=bwd, kw=kw: attention_dkv(plan, *bwd, **kw)),
        ]
    return cases


def sweep_tasks(plan, n, dev, gen) -> None:
    cases = _path_g(plan, n, dev, gen) + _path_h(plan, n, dev, gen)
    settings = [(task, group) for task in TASKS for group in GROUPS]
    times: dict = {}
    defaults = dict(_attn_core._TASK_BLOCKS), dict(_attn_core._HEAD_GROUP)
    try:
        for order in (settings, settings[::-1]):
            for task, group in order:
                for name, heads, d, fn in cases:
                    if group > heads:
                        continue
                    _attn_core._TASK_BLOCKS[name] = task
                    _attn_core._HEAD_GROUP[name] = group
                    times.setdefault((name, heads, d, task, group), []).append(cuda_ms(fn))
    finally:
        _attn_core._TASK_BLOCKS.clear()
        _attn_core._TASK_BLOCKS.update(defaults[0])
        _attn_core._HEAD_GROUP.clear()
        _attn_core._HEAD_GROUP.update(defaults[1])
    for (name, heads, d, task, group), ms in sorted(times.items()):
        print(f"{name} H{heads} d{d} task {task} head group {group}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms")


def _pieces_cases(plan, n, dev, gen, kernels):
    """(kernel, d, whole, hub alone, plan) for K9 and K10 at path H's widths."""
    w, hub = heaviest_window(plan)
    rows = slice(w * plan.config.block_h, w * plan.config.block_h + hub.num_nodes)
    print(f"hub window {w}: {hub.total_blocks} blocks of {plan.total_blocks}")
    cases = []
    for d in (8, 40):
        q, k, v, g = (torch.randn(n, d, device=dev, generator=gen) for _ in range(4))
        kw = dict(scale=1.0 / d ** 0.5, negative_slope=0.2)

        def fwd(p, q=q, k=k, v=v):
            return lambda: spmm_attention(p, q, k, v, negative_slope=0.2)

        def bwd(p, q=q, k=k, v=v, g=g, kw=kw):
            out, lse = spmm_attention(p, q, k, v, return_stats=True, negative_slope=0.2)
            return lambda: attention_bwd_summed(p, q, k, v, out, lse, g, **kw)

        qh, gh = q[rows].contiguous(), g[rows].contiguous()
        if "spmm_attention" in kernels:
            cases.append(("spmm_attention", d, fwd(plan), fwd(hub, qh), plan))
        if "attention_bwd" in kernels:
            cases.append(("attention_bwd", d, bwd(plan), bwd(hub, qh, g=gh), plan))
    return cases


def sweep_pieces(plan, n, dev, gen, kernels) -> None:
    cases = _pieces_cases(plan, n, dev, gen, kernels)
    settings = [(pb, pw) for pb in BLOCKS for pw in WORK]
    defaults = dict(block_spmm.PIECE_BLOCKS), dict(block_spmm.PIECE_WORK)
    times: dict = {}
    try:
        for order in (settings, settings[::-1]):
            for pb, pw in order:
                for name, d, whole, alone, p in cases:
                    block_spmm.PIECE_BLOCKS[name], block_spmm.PIECE_WORK[name] = pb, pw
                    key = (name, d, pb, pw)
                    if key not in times:
                        times[key] = {"stats": attention_walk_stats(p, name, d), "ms": [],
                                      "hub_ms": []}
                    times[key]["ms"].append(cuda_ms(whole))
                    times[key]["hub_ms"].append(cuda_ms(alone))
                torch.cuda.empty_cache()
    finally:
        for current, default in zip((block_spmm.PIECE_BLOCKS, block_spmm.PIECE_WORK), defaults):
            current.clear()
            current.update(default)
    for (name, d, pb, pw), t in sorted(times.items(), key=lambda kv: (*kv[0][:3], kv[0][3] or 0)):
        st = t["stats"]
        print(f"{name} d{d} PIECE_BLOCKS {pb} PIECE_WORK {pw}: {t['ms'][0]:.4f} / "
              f"{t['ms'][1]:.4f} ms; hub window alone {t['hub_ms'][0]:.4f} / "
              f"{t['hub_ms'][1]:.4f} ms; {st['pieces']} pieces, {st['cut_windows']} windows "
              f"cut, heaviest {st['max_task_work']} units of work (mean "
              f"{st['mean_task_work']:.1f}); workspace {st['workspace_mib']:.2f} MiB")


def sweep_mh(plan, n, dev, gen) -> None:
    """K13 over MH_BLOCKS x MH_WORK x MH_GROUPS at path G's two layers."""
    name = "spmm_attention_mh"
    w, hub = heaviest_window(plan)
    rows = slice(w * plan.config.block_h, w * plan.config.block_h + hub.num_nodes)
    print(f"hub window {w}: {hub.total_blocks} blocks of {plan.total_blocks}")
    kw = dict(negative_slope=0.2, plane_dtype=torch.bfloat16)
    cases = []
    for heads, d in ((8, 8), (1, 40)):
        # the model's node-major projections: (n, H * d) viewed as (H, n, d)
        q, k, v = (torch.randn(n, heads * d, device=dev, generator=gen)
                   .view(n, heads, d).permute(1, 0, 2) for _ in range(3))
        qh = q[:, rows]
        cases.append((heads, d, lambda q=q, k=k, v=v: spmm_attention_mh(plan, q, k, v, **kw),
                      lambda q=qh, k=k, v=v: spmm_attention_mh(hub, q, k, v, **kw)))
    settings = [(pb, pw, hg) for pb in MH_BLOCKS for pw in MH_WORK for hg in MH_GROUPS]
    defaults = (dict(block_spmm.PIECE_BLOCKS), dict(block_spmm.PIECE_WORK),
                attention_mh.HEAD_GROUP)
    times: dict = {}
    try:
        for order in (settings, settings[::-1]):
            for pb, pw, hg in order:
                block_spmm.PIECE_BLOCKS[name], block_spmm.PIECE_WORK[name] = pb, pw
                attention_mh.HEAD_GROUP = hg
                for heads, d, whole, alone in cases:
                    if heads == 1 and hg > 1:
                        continue  # one head takes a group of one
                    key = (heads, d, pb, pw, hg)
                    if key not in times:
                        times[key] = {"stats": attention_walk_stats(plan, name, d, heads),
                                      "ms": [], "hub_ms": []}
                    times[key]["ms"].append(cuda_ms(whole))
                    times[key]["hub_ms"].append(cuda_ms(alone))
                torch.cuda.empty_cache()
    finally:
        block_spmm.PIECE_BLOCKS.clear()
        block_spmm.PIECE_BLOCKS.update(defaults[0])
        block_spmm.PIECE_WORK.clear()
        block_spmm.PIECE_WORK.update(defaults[1])
        attention_mh.HEAD_GROUP = defaults[2]
    for (heads, d, pb, pw, hg), t in sorted(times.items()):
        st = t["stats"]
        print(f"{name} H{heads} d{d} PIECE_BLOCKS {pb} PIECE_WORK {pw} HEAD_GROUP {hg}: "
              f"{t['ms'][0]:.4f} / {t['ms'][1]:.4f} ms; hub window alone "
              f"{t['hub_ms'][0]:.4f} / {t['hub_ms'][1]:.4f} ms; {st['pieces']} pieces, "
              f"{st['cut_windows']} windows cut, heaviest {st['max_task_work']} units of work "
              f"(mean {st['mean_task_work']:.1f}); workspace {st['workspace_mib']:.2f} MiB")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    kernels = parser.parse_args().kernels
    if not torch.cuda.is_available():
        raise SystemExit("attn_task_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    loops = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    n = loops.shape[0]
    plan = csr_preprocess(loops.indptr, loops.indices, n, PlanConfig(128, 128, block_unroll=4))
    plan = plan.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if "tasks" in kernels:
        sweep_tasks(plan, n, dev, gen)
    if "spmm_attention_mh" in kernels:
        sweep_mh(plan, n, dev, gen)
    pieces = [k for k in kernels if k in ("spmm_attention", "attention_bwd")]
    if pieces:
        sweep_pieces(plan, n, dev, gen, pieces)


if __name__ == "__main__":
    main()

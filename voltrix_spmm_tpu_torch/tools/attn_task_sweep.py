"""The fused-attention kernels against their task size (plan blocks per
thread block) and head group (heads per thread block), by entry point, at
the shapes of chip_smoke.py's paths G and H: the ogbn-arxiv proxy with
self-loops, PlanConfig(128, 128, block_unroll=4).

- Path G, the multi-head entry points (K13, K14, K15): bf16 planes, layer 1
  (8 heads of width 8) and layer 2 (1 head of width 40).
- Path H, the single-head entry points (K9, K10, K11, K12): float32, one
  head of width 8 (a layer-1 head) and of width 40 (layer 2).

    python3 -m voltrix_spmm_tpu_torch.tools.attn_task_sweep

Needs one CUDA device. Each (entry point, width, task size, head group) is
timed twice with CUDA events (mean of 20 launches after 3 warm-up), the
settings in turns: up, then down. q, k, v and dO are random normal, made
from a seed.
"""

from __future__ import annotations

import subprocess

import numpy as np
import scipy.sparse as sp
import torch

from .. import PlanConfig, csr_preprocess
from ..data import proxy_csr, symmetrize
from ..ops import (
    _attn_core,
    attention_bwd,
    attention_dkv,
    attention_dq,
    attention_mh_dkv,
    attention_mh_dq,
    spmm_attention,
    spmm_attention_mh,
)
from .k6_piece_sweep import cuda_ms

TASKS = (1, 2, 4, 8, 16)
GROUPS = (1, 8)


def _path_g(plan, n, dev, gen):
    kw = dict(negative_slope=0.2, plane_dtype=torch.bfloat16)
    cases = []
    for heads, d in ((8, 8), (1, 40)):
        q, k, v, g = (torch.randn(heads, n, d, device=dev, generator=gen) for _ in range(4))
        out, lse = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
        bwd = (q, k, v, g, lse, (g * out).sum(-1))
        scale = 1.0 / d ** 0.5
        cases += [
            ("spmm_attention_mh", heads, d,
             lambda q=q, k=k, v=v: spmm_attention_mh(plan, q, k, v, **kw)),
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
        scale = 1.0 / d ** 0.5
        kw = dict(scale=scale, negative_slope=0.2)
        bwd = (q, k, v, g, lse, (g * out).sum(-1))
        cases += [
            ("spmm_attention", 1, d,
             lambda q=q, k=k, v=v: spmm_attention(plan, q, k, v, negative_slope=0.2)),
            ("attention_dq", 1, d, lambda bwd=bwd, kw=kw: attention_dq(plan, *bwd, **kw)),
            ("attention_dkv", 1, d, lambda bwd=bwd, kw=kw: attention_dkv(plan, *bwd, **kw)),
            ("attention_bwd", 1, d,
             lambda q=q, k=k, v=v, out=out, lse=lse, g=g, kw=kw:
             attention_bwd(plan, q, k, v, out, lse, g, **kw)),
        ]
    return cases


def main() -> None:
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


if __name__ == "__main__":
    main()

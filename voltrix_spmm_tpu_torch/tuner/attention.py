"""Attention-variant autotuner: plan geometry and plane dtype for the
all-head flash attention `ops.spmm_attention_mh_ad` (counterpart of
voltrix_spmm_tpu/tuner/attention.py).

Attention has one formulation (K13's online softmax forward, K14's dq and
K15's dk / dv over the transpose plan), so the space is the plan geometry
(window height, unroll, column clustering for `subtile`) of both plans and
the storage dtype of the k / v planes (float32 or bf16). mode="train" times
the forward and backward (K13, K14, K15), as the GAT models call it;
mode="fwd" times K13 alone. The race, its validity filter (a geometry
refusal or out-of-memory skips a candidate; any other failure stops the
race), the soft budget and the memory and disk caches are the SpMM tuner's.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..format.plan import PlanConfig, SpmmPlan
from ..format.preprocess import csr_preprocess
from .tuner import (Tuner, _bench, _code_version, _device_tag, _matrix_hash, _release,
                    candidate_invalid)


@dataclass(frozen=True)
class AttnVariant:
    block_h: int = 128
    block_unroll: int = 4
    plane_dtype: str | None = None  # None (float32) or "bfloat16"
    subtile: bool = False  # clustered plans; the walks skip empty 128-row sub-windows

    @property
    def plan_config(self) -> PlanConfig:
        return PlanConfig(self.block_h, 128, 1, self.block_unroll, cluster_cols=self.subtile)

    def key(self) -> str:
        return (f"attn/h{self.block_h}u{self.block_unroll}{'st' if self.subtile else ''}"
                f"/{self.plane_dtype or 'float32'}")


def attention_default_space(accurate: bool = False, dk: int | None = None,
                            dv: int | None = None, heads: int | None = None,
                            nnz: int | None = None) -> list[AttnVariant]:
    """The JAX package's space: window heights {128, 256, 512, 1024} x
    planes {float32, bf16} (bf16 unless `accurate`), clustered twins at 512
    and 1024 rows, where sub-windows can be empty, and unroll 8 at 256 rows
    (bf16 twins at 256 and, clustered, at 512)."""
    del dk, dv, heads, nnz
    heights = [128, 256, 512, 1024]
    space = [AttnVariant(h, 4) for h in heights]
    if not accurate:
        space += [AttnVariant(h, 4, "bfloat16") for h in heights]
    for h in (512, 1024):
        space.append(AttnVariant(h, 4, None, subtile=True))
        if not accurate:
            space.append(AttnVariant(h, 4, "bfloat16", subtile=True))
    space.append(AttnVariant(256, 8))
    if not accurate:
        space.append(AttnVariant(256, 8, "bfloat16"))
        space.append(AttnVariant(512, 8, "bfloat16", subtile=True))
    return space


def _plane(variant: AttnVariant):
    return torch.bfloat16 if variant.plane_dtype == "bfloat16" else None


@dataclass
class TunedAttention:
    """The best (plan pair, variant) for one adjacency and head geometry;
    call it like `spmm_attention_mh_ad(q, k, v)`."""

    plan: SpmmPlan
    plan_t: SpmmPlan
    variant: AttnVariant
    time_ms: float
    negative_slope: float = 0.2
    candidates: dict = field(default_factory=dict)
    plan_seconds: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)

    def __call__(self, q, k, v, **kw):
        from ..ops.attention_mh import spmm_attention_mh_ad

        kw.setdefault("negative_slope", self.negative_slope)
        if self.variant.plane_dtype:
            kw.setdefault("plane_dtype", _plane(self.variant))
        if self.variant.subtile:
            kw.setdefault("subtile", True)
        return spmm_attention_mh_ad(self.plan, q, k, v, plan_t=self.plan_t, **kw)


class AttentionTuner(Tuner):
    file_prefix = "tune_attn"

    def compile_and_tune(
        self,
        indptr,
        indices,
        num_nodes: int,
        *,
        heads: int,
        dk: int,
        dv: int,
        at_indptr=None,
        at_indices=None,
        mode: str = "train",
        space: list[AttnVariant] | None = None,
        hash_tag: str | None = None,
        iters: int = 8,
        negative_slope: float = 0.2,
        accurate: bool = False,
        seed: int = 0,
        budget_s: float | None = None,
        device="cuda",
    ) -> TunedAttention:
        """Race attention variants on this adjacency and head geometry on
        `device` (the card unless the caller asks for the CPU).

        at_indptr / at_indices: CSR of A^T for K15's transpose plan; None
        treats A as symmetric (the forward plan serves both). mode: "train"
        times a loss's value and gradients through the op (K13, K14, K15);
        "fwd" times the forward (K13). budget_s: soft budget in seconds
        (default $VOLTRIX_TORCH_TUNE_BUDGET_S). The winner and every
        candidate's time are cached on disk by (matrix hash or hash_tag,
        H / dk / dv, mode, accurate, device, code version)."""
        if mode not in ("train", "fwd"):
            raise ValueError(f"mode must be 'train' or 'fwd', not {mode!r}")
        device = torch.device(device)
        budget_s = self._budget(budget_s)
        mat = hash_tag or _matrix_hash(indptr, indices, num_nodes)
        sig = (f"{mat}.H{heads}k{dk}v{dv}.{mode}{'A' if accurate else ''}"
               f".{_device_tag(device)}.{_code_version()}")
        if sig in self._mem:
            return self._mem[sig]
        if space is None:
            space = attention_default_space(accurate=accurate, dk=dk, dv=dv, heads=heads,
                                            nnz=len(indices))
        by_key = {v.key(): v for v in space}

        def plans_of(var: AttnVariant):
            plan = csr_preprocess(indptr, indices, num_nodes, var.plan_config).to(device)
            if at_indptr is None:
                return plan, plan
            return plan, csr_preprocess(at_indptr, at_indices, num_nodes,
                                        var.plan_config).to(device)

        disk = self._disk_path(sig)
        cached = None
        if os.path.exists(disk):
            try:
                with open(disk) as f:
                    cached = json.load(f)
            except ValueError:
                cached = None
        if cached is not None and cached.get("winner") in by_key:
            win = by_key[cached["winner"]]
            tuned = TunedAttention(*plans_of(win), win, float(cached.get("time_ms", 0.0)),
                                   negative_slope, dict(cached.get("candidates", {})),
                                   dict(cached.get("plan_seconds", {})),
                                   dict(cached.get("errors", {})))
            self._mem[sig] = tuned
            self._say(f"disk hit for {sig}: {win.key()}")
            return tuned

        from ..ops.attention_mh import spmm_attention_mh_ad

        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.standard_normal((heads, num_nodes, w)).astype(np.float32)
                                    ).to(device).requires_grad_(mode == "train")
                   for w in (dk, dk, dv))
        base_bytes = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            base_bytes = torch.cuda.memory_allocated(device)
        results: dict[str, float] = {}
        plan_s: dict[str, float] = {}
        errors: dict[str, str] = {}
        best = None  # (variant, ms)
        t_begin = time.perf_counter()
        for var in space:
            key = var.key()
            if (budget_s is not None and best is not None
                    and time.perf_counter() - t_begin > budget_s):
                continue
            try:
                t0 = time.perf_counter()
                plan, plan_t = plans_of(var)
                plan_s[key] = time.perf_counter() - t0
                kw = dict(plan_t=plan_t, negative_slope=negative_slope,
                          plane_dtype=_plane(var), subtile=var.subtile)

                if mode == "train":
                    def step(p=plan, kw=kw):
                        out = spmm_attention_mh_ad(p, q, k, v, **kw)
                        loss = (out * (1.0 + 1e-6 * out)).sum()
                        return torch.autograd.grad(loss, (q, k, v))
                else:
                    def step(p=plan, kw=kw):
                        with torch.no_grad():
                            return spmm_attention_mh_ad(p, q, k, v, **kw)

                t = _bench(step, device, iters)
            except Exception as e:
                if not candidate_invalid(e):
                    raise RuntimeError(f"tune_attention: candidate {key} failed; the race "
                                       f"stops: {type(e).__name__}: {e}") from e
                t, errors[key] = math.nan, f"{type(e).__name__}: {e}"
            plan = plan_t = step = kw = None
            _release(device, base_bytes, key)
            results[key] = t
            self._say(f"{key}: {t:.4f} ms" + (f" ({errors[key]})" if key in errors else ""))
            if not math.isnan(t) and (best is None or t < best[1]):
                best = (var, t)
        if best is None:
            raise RuntimeError(f"tune_attention: no valid candidate (space={len(space)}, "
                               f"results={results}, errors={errors})")

        os.makedirs(self.cache_dir(), exist_ok=True)
        tmp = disk + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"winner": best[0].key(), "time_ms": best[1],
                       "candidates": {kk: (None if math.isnan(tt) else tt)
                                      for kk, tt in results.items()},
                       "plan_seconds": plan_s, "errors": errors}, f, indent=1)
        os.replace(tmp, disk)
        tuned = TunedAttention(*plans_of(best[0]), best[0], best[1], negative_slope,
                               dict(results), plan_s, errors)
        self._mem[sig] = tuned
        return tuned


attention_tuner = AttentionTuner()


def tune_attention(indptr, indices, num_nodes: int, **kw) -> TunedAttention:
    """The module's `AttentionTuner` (as `tune_spmm` is the SpMM tuner's)."""
    return attention_tuner.compile_and_tune(indptr, indices, num_nodes, **kw)

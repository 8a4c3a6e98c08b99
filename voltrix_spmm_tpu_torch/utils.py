"""Accuracy utilities, test data and fp8 helpers (counterpart of
voltrix_spmm_tpu/utils.py:28-47 and :291-368), the tuner's timers
(`CPU_bench`, `gpu_bench`) and `env_flag`, and `kept_beside`, the cache of
what is built once per tensor (work lists, edge orders).

Both metrics are taken in float64 on the host, so a tensor on the card
is copied back first.
"""

from __future__ import annotations

import logging
import os
import time
import weakref

import numpy as np
import torch

logger = logging.getLogger("voltrix_torch")

_KEPT: dict[int, dict] = {}  # id(anchor) -> {key: (weak refs to the tensors read, value)}


def kept_beside(anchor: torch.Tensor, key, build, *tensors):
    """What `build()` returns, built at the first call and kept beside the
    tensor `anchor` until it is freed, under `key` and checked against the
    identity of `tensors` (the other tensors it was built from; None
    allowed). A dataclass copy that shares these tensors, such as
    `dataclasses.replace(plan, values=...)`, finds the same value; a copy
    with a new tensor in their place builds its own. The value must not
    hold `anchor` itself, or the two are never freed."""
    cache = _KEPT.get(id(anchor))
    if cache is None:
        cache = _KEPT[id(anchor)] = {}
        weakref.finalize(anchor, _KEPT.pop, id(anchor), None)
    read = (anchor, *tensors)
    hit = cache.get(key)
    if hit is not None and all((r is None) if t is None else (r is not None and r() is t)
                               for r, t in zip(hit[0], read)):
        return hit[1]
    value = build()
    cache[key] = (tuple(None if t is None else weakref.ref(t) for t in read), value)
    return value


def env_flag(name: str) -> bool:
    return os.environ.get(name, "0") not in ("", "0", "false", "False")


def CPU_bench(fn, iters: int = 10, warmup: int = 2) -> float:
    """Wall-clock host time of fn() in ms a call, after `warmup` calls: the
    tuner's timer for a race on the CPU (the plain versions), which the
    tests run."""
    for _ in range(warmup):
        fn()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - start) / iters * 1e3


_FLUSH_BYTES = 256 * 2**20  # past the H100's 50 MB L2, as bench_kineto flushes


def gpu_bench(fn, iters: int = 8, warmup: int = 2, device=None) -> float:
    """Median device ms of fn() over `iters` launches on the card, each
    timed alone by CUDA events after a write of 256 MiB that flushes the
    L2 (so every launch reads its inputs from device memory, as the
    reference's bench_kineto times). The `warmup` calls before pay for what
    a first launch builds (nvcc builds, work lists, the registered ops'
    operands) outside the timed window."""
    device = torch.device("cuda") if device is None else torch.device(device)
    for _ in range(warmup):
        fn()
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    del flush
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def calc_diff(x, y) -> float:
    """Cosine-style "difference rate": ``1 - 2 x·y / (|x|^2 + |y|^2)``.
    0.0 means identical."""
    x, y = _to_numpy(x), _to_numpy(y)
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        logger.warning("calc_diff: non-finite values present")
    denom = (x * x).sum() + (y * y).sum()
    if denom == 0.0:
        return 0.0
    sim = 2.0 * (x * y).sum() / denom
    return float(1.0 - sim)


def relative_error(ref, out, eps: float = 1e-12) -> float:
    """Frobenius relative error |out - ref| / |ref|."""
    ref, out = _to_numpy(ref), _to_numpy(out)
    return float(np.linalg.norm(out - ref) / (np.linalg.norm(ref) + eps))


def gen_outlier_normal(shape, outlier_frac: float = 0.01, outlier_scale: float = 50.0,
                       seed: int = 0) -> np.ndarray:
    """float32 Gaussian data in which a fraction `outlier_frac` of the
    entries is scaled by `outlier_scale`: the data of the int8 SpMM's
    tests, which stresses the per-row scales. The same numpy draws as the
    JAX package's, so both give the same array."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random(shape) < outlier_frac
    return np.where(mask, x * outlier_scale, x)


# --- fp8 helpers ----------------------------------------------------------
# Plain functions beside the int8 SpMM, as in the JAX package (no SpMM
# kernel reads fp8). E4M3's largest finite value, 448, is the scale's
# denominator.

FP8_MAX = 448.0
# float8_e4m3fn has no infinity: the JAX package's cast (ml_dtypes) turns a
# value past the rounding midpoint above 448 into NaN of its sign, while
# torch's saturates to +-448; the port follows the JAX package
_FP8_NAN_FROM = 464.0


def _cast_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    q = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return q
    over = x.abs() > _FP8_NAN_FROM  # infinities too
    nan_bits = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(over, nan_bits, q.view(torch.uint8)).view(dtype)


def round_quant_fp8(x: torch.Tensor, lfp_t=None) -> torch.Tensor:
    """A plain cast to fp8 (float8_e4m3fn unless `lfp_t` says otherwise)."""
    return _cast_fp8(torch.as_tensor(x), lfp_t or torch.float8_e4m3fn)


def per_tensor_quant_fp8(x: torch.Tensor, lfp_t=None):
    """(x_fp8, scale): one absmax / 448 scale for the whole tensor."""
    x = torch.as_tensor(x)
    scale = torch.clamp(x.abs().max() / FP8_MAX, min=1e-30)
    return _cast_fp8(x / scale, lfp_t or torch.float8_e4m3fn), scale.to(torch.float32)


def per_tensor_dequant_fp8(q: torch.Tensor, scale, hfp_t=None) -> torch.Tensor:
    return q.to(hfp_t or torch.float32) * scale


def block_quant_fp8(x: torch.Tensor, blk_shape=(128, 128), lfp_t=None):
    """(x_fp8, scales (M/bm, N/bn)): one absmax / 448 scale per tile,
    values clamped to the E4M3 range."""
    x = torch.as_tensor(x)
    m, n = x.shape
    bm, bn = blk_shape
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(x.shape)} is not a multiple of the tile {blk_shape}")
    qm, qn = m // bm, n // bn
    t = x.reshape(qm, bm, qn, bn)
    scales = t.abs().amax(dim=(1, 3)) / FP8_MAX
    scales = torch.where(scales == 0, 1.0, scales)
    q = torch.clamp(t / scales[:, None, :, None], -FP8_MAX, FP8_MAX).reshape(m, n)
    return _cast_fp8(q, lfp_t or torch.float8_e4m3fn), scales.to(torch.float32)


def block_dequant_fp8(q: torch.Tensor, scales: torch.Tensor, blk_shape=(128, 128),
                      hfp_t=None) -> torch.Tensor:
    m, n = q.shape
    bm, bn = blk_shape
    qm, qn = scales.shape
    if m != qm * bm or n != qn * bn:
        raise ValueError(f"q {tuple(q.shape)} does not match scales {tuple(scales.shape)} "
                         f"of tiles {blk_shape}")
    t = q.to(hfp_t or torch.float32).reshape(qm, bm, qn, bn)
    return (t * scales[:, None, :, None]).reshape(m, n)

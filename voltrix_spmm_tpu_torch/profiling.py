"""Profiling and tracing helpers (counterpart of
voltrix_spmm_tpu/profiling.py, on `torch.profiler`).

`trace` and `start_profiler` / `stop_profiler` record a Chrome trace
(chrome://tracing, Perfetto); `annotate` names a range in it;
`profile_op` returns the time of each kernel on the card (each op on the
CPU) per call, as the JAX package's table; `attribute_spmm` buckets that
table into the SpMM kernels, the gathers and the rest by the kernels'
own names; `compiled_stats` is serve.py's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .serve import compiled_stats

_ACTIVE: list = []  # the profiler start_profiler started, with its directory


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the body into a Chrome trace under `log_dir` (its path is
    printed)."""
    with profile(activities=_activities()) as prof:
        yield prof
    print(f"voltrix_torch trace: {_export(prof, log_dir)}")


def annotate(name: str):
    """A named range in the trace (`torch.profiler.record_function`)."""
    return record_function(name)


def start_profiler(log_dir: str):
    """Start recording; `stop_profiler` writes the trace under `log_dir`."""
    prof = profile(activities=_activities())
    prof.start()
    _ACTIVE.append((prof, log_dir))


def stop_profiler() -> str:
    """Stop what `start_profiler` started; return the trace's path."""
    prof, log_dir = _ACTIVE.pop()
    prof.stop()
    return _export(prof, log_dir)


def profile_op(fn, *args, iters: int = 3, warmup: int = 2, log_dir=None):
    """Run fn(*args) `iters` times under the profiler (after `warmup`
    calls) and return the time table [{"op", "ms_per_iter", "count"}],
    largest first: each kernel's device time when the arguments lie on the
    card, else each op's own CPU time. With `log_dir` the trace is also
    written there."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(max(warmup, 1)):
        fn(*args)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn(*args)
        sync()
    if log_dir is not None:
        _export(prof, log_dir)
    table = []
    for e in prof.key_averages():
        if cuda:
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
        else:
            us = e.self_cpu_time_total
        if us > 0:
            table.append({"op": e.key, "ms_per_iter": us / 1e3 / iters, "count": e.count})
    table.sort(key=lambda r: -r["ms_per_iter"])
    return table


# the SpMM kernels' names: K1, K2 and K8's walk and its merge
# (csrc/spmm_walk.cuh), K3's (csrc/spmm_fused.cu), and the registered ops
# (ops/library.py) in a CPU table
SPMM_KERNEL_NAMES = ("spmm_walk_kernel", "spmm_merge_kernel", "spmm_fused_kernel", "voltrix::")
GATHER_NAMES = ("index_select", "indexSelect", "gather")


def attribute_spmm(table, plan=None) -> dict:
    """Bucket a `profile_op` table into SpMM kernel, gather and other
    milliseconds per call by name (SPMM_KERNEL_NAMES, GATHER_NAMES), with
    the total and the shares. The port's kernels gather their rows
    themselves, so on the card the gather bucket holds only the gathers
    outside them; `plan` is taken for the JAX package's signature."""
    out = {"gather_ms": 0.0, "kernel_ms": 0.0, "other_ms": 0.0}
    for row in table:
        name, ms = row["op"], row["ms_per_iter"]
        if any(k in name for k in SPMM_KERNEL_NAMES):
            out["kernel_ms"] += ms
        elif any(k in name for k in GATHER_NAMES):
            out["gather_ms"] += ms
        else:
            out["other_ms"] += ms
    tot = sum(out.values())
    out["total_ms"] = tot
    if tot > 0:
        out["gather_frac"] = out["gather_ms"] / tot
        out["kernel_frac"] = out["kernel_ms"] / tot
    return out


__all__ = ["trace", "annotate", "start_profiler", "stop_profiler", "profile_op",
           "attribute_spmm", "compiled_stats", "SPMM_KERNEL_NAMES"]

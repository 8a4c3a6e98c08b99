"""Collectives of the parallel trainers, and a launcher of ranks.

The torch.distributed form of the jax.lax collectives that the JAX
package's parallel/ modes use:

- `all_gather` (tiled along dim 0; `lax.all_gather(..., tiled=True)`),
  whose backward is a reduce-scatter;
- `psum_scatter` (a reduce-scatter, tiled along dim 0), whose backward is
  an all-gather;
- `allreduce_identity_bwd`: a sum over the group whose backward is the
  identity (the Megatron row-parallel rule of sharded.py:67-75);
- `psum`: a sum over the group outside autograd (gradients, counts);
- `ppermute`: a ring shift by `dist.batch_isend_irecv`, started now and
  waited for later, so a block SpMM runs while the chunk travels.

A mesh axis (a name of a `DeviceMesh` dimension, or a tuple of names) maps
to a process group by `axis_group`; a rank's shard along the axis is its
rank in that group, so the all-gather stacks the shards in the order of
the JAX axis.

Backends: "nccl" for CUDA tensors when every rank has a card of its own,
"gloo" for CPU tensors; gloo also takes CUDA tensors, so several ranks can
share one card (NCCL refuses two ranks on one GPU). Where gloo cannot take a
CUDA tensor for an op, the op goes through host memory: the choice is the
fixed table `STAGED`, read from `python3 -m
voltrix_spmm_tpu_torch.tools.gloo_probe` on the card, never from catching
an error. Under NCCL nothing is staged.

`launch(fn, world_size, ...)` starts `world_size` ranks with
torch.multiprocessing (spawn), each running fn(rank, world_size, *args)
on the card (or the CPU when asked) after `init_process_group` on a file
store in a temporary directory, and
returns each rank's result with its tensors as numpy arrays; it raises in
the parent, with the rank's traceback, when a rank fails, dies or hangs
past `timeout`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

# (backend, op) pairs whose CUDA tensors go through host memory. Ops:
# "all_gather", "psum_scatter", "psum", "ppermute". tools/gloo_probe.py on
# torch 2.11 with an H100: gloo takes CUDA tensors for the all-gather,
# reduce-scatter and all-reduce as they are, but its send and receive
# fail on them (tcp/pair.cc: "writev ... Bad address"); NCCL takes all four.
STAGED = frozenset({("gloo", "ppermute")})

# bytes this rank's collectives sent, by op, as the ring algorithms count
# them (all-gather (n - 1) shards, reduce-scatter (n - 1) / n of its input,
# all-reduce twice that, a ring shift its tensor), and under "staged" the
# bytes copied between the card and host memory for staged ops; read and
# cleared by chip_smoke.py
traffic = Counter()


def staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether `op` on `t` goes through host memory in `group` (`STAGED`)."""
    return t.is_cuda and (dist.get_backend(group), op) in STAGED


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    traffic["staged"] += _nbytes(t)
    return t.cpu()


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    traffic["staged"] += _nbytes(t)
    return t.to(device)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    stage = staged("all_gather", x, group)
    src = _to_host(x) if stage else x.contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather(list(out.chunk(n)), src, group=group)
    traffic["all_gather"] += (n - 1) * _nbytes(x)
    return _to_device(out, x.device) if stage else out


def _scatter(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split over {n} ranks")
    stage = staged("psum_scatter", x, group)
    src = _to_host(x) if stage else x.contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter(out, list(src.chunk(n)), op=dist.ReduceOp.SUM, group=group)
    traffic["psum_scatter"] += (n - 1) * _nbytes(x) // n
    return _to_device(out, x.device) if stage else out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group` (a new tensor; no gradient)."""
    n = dist.get_world_size(group)
    stage = staged("psum", x, group)
    buf = _to_host(x.detach()) if stage else x.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    traffic["psum"] += 2 * (n - 1) * _nbytes(x) // n
    return _to_device(buf, x.device) if stage else buf


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad.contiguous(), ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad.contiguous(), ctx.group), None


class _AllReduceIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's shards of `x` stacked along dim 0 in group-rank order;
    its gradient is the reduce-scatter of the output's gradient."""
    return _AllGather.apply(x, group)


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, cut along dim 0 into as many row
    blocks as ranks: this rank keeps the block of its group rank. Its
    gradient is the all-gather of the output's gradient."""
    return _PsumScatter.apply(x, group)


def allreduce_identity_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, whose backward passes the output's
    gradient through unchanged: each rank's partial sum receives the plain
    cotangent (the Megatron row-parallel rule). A sum whose backward sums
    again, as `torch.distributed.nn.functional.all_reduce` differentiates,
    would scale every upstream gradient by the group's size."""
    return _AllReduceIdentityBwd.apply(x, group)


class Pending:
    """A ring shift in flight: `wait()` returns the received tensor."""

    def __init__(self, works, recv, device, keep):
        self._works, self._recv, self._device, self._keep = works, recv, device, keep

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._keep = None
        if self._device.type == "cuda" and not self._recv.is_cuda:
            return _to_device(self._recv, self._device)
        return self._recv


def ppermute(x: torch.Tensor, group, offset: int) -> Pending:
    """Start sending `x` to the group rank `offset` ahead (modulo the
    group's size) and receiving the tensor of the rank `offset` behind;
    the JAX perm [(i, (i + offset) % n)]. Returns the `Pending` shift."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src = _to_host(x.detach()) if staged("ppermute", x, group) else x.detach().contiguous()
    recv = torch.empty_like(src)
    if n == 1:
        recv.copy_(src)
        return Pending([], recv, x.device, None)
    to = dist.get_global_rank(group, (me + offset) % n)
    frm = dist.get_global_rank(group, (me - offset) % n)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, to, group),
        dist.P2POp(dist.irecv, recv, frm, group),
    ])
    traffic["ppermute"] += _nbytes(x)
    return Pending(works, recv, x.device, src)


def axis_group(mesh, axis):
    """The process group of mesh axis `axis` (a dimension name of the
    `DeviceMesh`, or a tuple of names in the mesh's order, whose ranks
    are numbered row-major over those dimensions as in the JAX package's
    P((a, b))). Groups of a tuple are made once per mesh; every rank must
    ask for the same tuples in the same order."""
    if isinstance(axis, str) or len(axis) == 1:
        return mesh.get_group(axis if isinstance(axis, str) else axis[0])
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) if a in names else -1 for a in axis]
    if -1 in dims or dims != sorted(dims) or len(set(dims)) != len(dims):
        raise ValueError(f"axis {axis} must name dimensions of the mesh {names} in its order")
    groups = mesh.__dict__.setdefault("_voltrix_axis_groups", {})
    if tuple(axis) not in groups:
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, int(np.prod(
            [mesh.mesh.shape[d] for d in dims])))
        me = dist.get_rank()
        for row in ranks.tolist():
            g = dist.new_group(row)
            if me in row:
                groups[tuple(axis)] = g
    return groups[tuple(axis)]


def shard_index(mesh, axis) -> int:
    """This rank's shard along `axis`: its rank in `axis_group(mesh, axis)`."""
    return dist.get_rank(axis_group(mesh, axis))


def device_mesh(shape, names):
    """A DeviceMesh of `shape` over the world's ranks in rank order, with
    dimension names `names`: of device type "cuda" under NCCL, else "cpu"
    (gloo's groups take CUDA tensors as well)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def rank_device(device=None) -> torch.device:
    """Where this rank computes: the CPU when `device` asks for it, else
    the card cuda:{local rank % device_count} (LOCAL_RANK as the launcher
    and torchrun set it, else the global rank)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu" or device.index is not None:
            return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _numpy(obj):
    """`obj` with every tensor (in dicts, lists and tuples) as a numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy(v) for v in obj)
    return obj


def _rank_main(rank, world_size, backend, device, tmp, timeout, results):
    """One rank: one host thread, its device, the process group, the job
    (fn, args) that the launcher wrote to tmp/job.pkl, and one message on
    `results`: ("ok", rank, result) or ("error", rank, traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        out = _numpy(fn(rank, world_size, *args))
    except Exception:
        # posted before the group goes down, so a rank's own failure
        # arrives before the broken connections it causes in its peers
        results.put(("error", rank, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put(("ok", rank, out))


def default_backend(world_size: int, device: str) -> str:
    """"gloo" on the CPU; on the card "nccl" when every rank has a card of
    its own, else "gloo" (the ranks share the cards)."""
    if device == "cpu":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def launch(fn, world_size: int, *args, backend: str | None = None, device: str = "cuda",
           timeout: float = 120.0) -> list:
    """Run fn(rank, world_size, *args) on `world_size` ranks, each a
    process started by torch.multiprocessing with the spawn method, joined
    through a file store in a fresh temporary directory (no TCP port, so
    launches may run side by side). fn and args travel pickled through a
    file of that directory, which every rank reads (fn: a function of an
    importable module). Each rank runs one host thread
    (torch.set_num_threads(1)) and, with device="cuda", the default,
    takes the card rank % device_count; device="cpu" keeps it on the CPU.

    backend: `default_backend(world_size, device)` unless given: "gloo" on
    the CPU; on the card "nccl" when every rank has a card of its own, else
    "gloo", with which several ranks share one card (NCCL refuses two ranks
    on one GPU, so "nccl" with more ranks than cards is refused here).

    Returns the ranks' results in rank order, tensors as numpy arrays.
    Raises RuntimeError with the rank's traceback when a rank raises or
    dies, and TimeoutError when the ranks have not all finished within
    `timeout` seconds; either way every rank is stopped first."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device == "cuda" and not torch.cuda.is_available():
        raise ValueError("device 'cuda' asked for, but no CUDA device is available; pass "
                         "device='cpu' to run the ranks on the CPU")
    backend = backend or default_backend(world_size, device)
    if backend not in ("nccl", "gloo") or (backend == "nccl" and device != "cuda"):
        raise ValueError(f"backend {backend!r} does not take device {device!r}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"nccl takes one rank a card: {world_size} ranks, "
                         f"{torch.cuda.device_count()} cards (gloo lets ranks share a card)")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="voltrix_launch_")
    deadline = time.monotonic() + timeout
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, backend, device, tmp, timeout, results))
        for r in range(world_size)]
    done, started = {}, []
    try:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
            started.append(p)
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(world_size) if r not in done]
                raise TimeoutError(f"ranks {missing} of {world_size} did not finish within "
                                   f"{timeout} s")
            try:
                kind, rank, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    try:  # the rank's traceback may still be on its way
                        kind, rank, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                else:
                    continue
            if kind == "error":
                failed = [(rank, payload)]
                try:  # the peers' failures that this one caused, for the report
                    while True:
                        kind, rank, payload = results.get(timeout=1.0)
                        if kind == "error":
                            failed.append((rank, payload))
                except queue.Empty:
                    pass
                raise RuntimeError("\n".join(f"rank {r} of {world_size} failed:\n{tb}"
                                             for r, tb in failed))
            done[rank] = payload
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world_size)]

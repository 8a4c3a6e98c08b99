"""Rank workers that hold the parallel modes to a reference: each runs on
every rank of a `comm.launch` and returns this rank's results as numpy
arrays, which the caller assembles (`plan.assemble`, `full_gcn_params`)
and compares. The port's tests run them on gloo CPU ranks against the JAX
package; `chip_smoke.py` runs `train_cases` on the card against the
single-process step.

- `spmm_cases`: each mode's SpMM and its gradient on a cotangent;
- `train_cases`: steps of each mode's trainer, with launches, times,
  bytes and peak memory;
- `refusal_cases`: the ValueError of each refused call;
- `fail_on_rank`, `sleep_on_rank`: a rank that raises or hangs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import comm


def problem_arrays(indptr, n: int, n_pad: int, d: int, classes: int, seed: int, batch: int = 0):
    """The features and labels of a problem from `seed` (numpy): x (n_pad,
    d) float32 and y (n_pad,) int64 with zero rows and label -100 past n,
    inv_deg (n_pad,) (0 past n), and with `batch` a batch xb (batch, n, d),
    yb (batch, n) of as many feature sets for the dp x tp trainer."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.standard_normal((n, d), dtype=np.float32)
    y = np.full(n_pad, -100, np.int64)
    y[:n] = rng.integers(0, classes, n)
    inv_deg = np.zeros(n_pad, np.float32)
    inv_deg[:n] = 1.0 / np.maximum(np.diff(np.asarray(indptr)), 1).astype(np.float32)
    out = {"x": x, "y": y, "inv_deg": inv_deg}
    if batch:
        out["xb"] = rng.standard_normal((batch, n, d), dtype=np.float32)
        out["yb"] = rng.integers(0, classes, (batch, n))
    return out


def _mesh_and_index(case, world_size):
    """The case's mesh, the axis its rows shard over, and this rank's shard."""
    mode = case["mode"]
    if mode in ("row_sharded", "ring"):
        mesh, axis = comm.device_mesh((world_size,), ("data",)), "data"
    elif mode == "hybrid":
        mesh, axis = comm.device_mesh(case["mesh"], ("host", "chip")), ("host", "chip")
    elif mode == "grid2d":
        mesh, axis = comm.device_mesh(case["mesh"], ("row", "col")), ("row", "col")
    elif mode == "row_sharded_2d":
        mesh, axis = comm.device_mesh(case["mesh"], ("host", "chip")), ("host", "chip")
    else:
        raise ValueError(f"no rows to shard in mode {mode!r}")
    return mesh, axis, comm.shard_index(mesh, axis)


def spmm_cases(rank: int, world_size: int, cases: dict, device: str) -> dict:
    """For each case {"mode", "plan", "x", "w"[, "mesh"]} (global padded
    arrays): this rank's shard index, its rows of A @ x through the mode's
    SpMM, and its rows of the gradient of sum((A @ x) * w) in x. A "dp_tp"
    case {"mode", "indptr", "indices", "n", "cfg", "mesh", "feat", "params",
    "x", "w"} gives the SpMM of this rank's column slice of feat, the GCN
    logits of its graphs of x and the gradients of sum(logits * w) in its
    parameter slices."""
    from .grid2d import grid2d_spmm
    from .hybrid import hybrid_sharded_spmm
    from .ring import ring_sharded_spmm
    from .row_sharded import row_sharded_spmm
    from .row_sharded_gcn import _local_aggregate

    dev = comm.rank_device(device)
    out = {}
    for name, case in cases.items():
        if case["mode"] == "dp_tp":
            out[name] = _dp_tp_forward(case, dev)
            continue
        mesh, axis, index = _mesh_and_index(case, world_size)
        plan = case["plan"]
        x = torch.from_numpy(plan.rows_of(case["x"], index)).to(dev).requires_grad_(True)
        w = torch.from_numpy(plan.rows_of(case["w"], index)).to(dev)
        if case["mode"] == "row_sharded":
            with torch.no_grad():
                y = row_sharded_spmm(plan, x, mesh, axis)
            agg = _local_aggregate(plan, plan.local(index, dev), x, comm.axis_group(mesh, axis))
        else:
            fn = {"ring": lambda v: ring_sharded_spmm(plan, v, mesh, axis),
                  "hybrid": lambda v: hybrid_sharded_spmm(plan, v, mesh),
                  "grid2d": lambda v: grid2d_spmm(plan, v, mesh)}[case["mode"]]
            y = agg = fn(x)
        (grad,) = torch.autograd.grad((agg * w).sum(), x)
        out[name] = {"index": index, "out": y.detach(), "grad": grad}
    return out


def _dp_tp_forward(case, dev) -> dict:
    from .sharded import sharded_gcn_forward, sharded_spmm

    mesh, coords, g, params, batch = _dp_tp_setup(case["mesh"], case, case["params"], dev)
    feat = np.ascontiguousarray(np.split(case["feat"], case["mesh"][1], axis=1)[coords[1]])
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    logits = sharded_gcn_forward(params, g, batch(case["x"]), mesh)
    grads = torch.autograd.grad((logits * batch(case["w"])).sum(), list(params.values()))
    return {"coords": coords, "spmm": sharded_spmm(g.plan, torch.from_numpy(feat).to(dev), mesh),
            "logits": logits.detach(), "grads": dict(zip(params, grads))}


def _timer(dev):
    """A start/stop pair: CUDA events on the card (ms of the device's
    timeline), the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


def train_cases(rank: int, world_size: int, spec: dict, device: str) -> dict:
    """`spec["steps"]` SGD steps (lr spec["lr"]) of each case of
    spec["cases"] ({"name", "mode", "plan", "mesh"}) on the problem of
    spec (indptr, indices, n, cfg, params in the JAX layout, d, classes,
    seed, batch: `problem_arrays`). Per case this rank returns its shard
    index (or dp x tp coordinates), the losses, the final parameters (dp x
    tp: its slices), its step-0 logits rows when spec["logits"], the K1
    launches and plain-version calls of the steps, each step's ms (CUDA
    events on the card) and host ms, the collectives' bytes
    (`comm.traffic`), the set-up seconds and, on the card, the peak memory
    of the steps."""
    from ..models import gcn_params_from_jax
    from ..ops import spmm_reference
    from ..ops.block_spmm import spmm_block
    from .grid2d import make_grid2d_train_step
    from .hybrid import make_hybrid_train_step
    from .ring import make_ring_train_step
    from .row_sharded_gcn import make_row_sharded_train_step

    dev = comm.rank_device(device)
    by_pad = {}  # the problem's arrays by padded row count

    def problem(n_pad):
        if n_pad not in by_pad:
            by_pad[n_pad] = problem_arrays(spec["indptr"], spec["n"], n_pad, spec["d"],
                                           spec["classes"], spec["seed"], spec.get("batch", 0))
        return by_pad[n_pad]

    params0 = gcn_params_from_jax(spec["params"], dev)
    makers = {"row_sharded": make_row_sharded_train_step, "ring": make_ring_train_step,
              "row_sharded_2d": make_row_sharded_train_step}
    out = {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        mode, plan = case["mode"], case.get("plan")
        if mode == "dp_tp":
            mesh, coords, g, params, batch = _dp_tp_setup(case["mesh"], spec, spec["params"], dev)
            arrays = problem(spec["n"])
            res, step = {"coords": coords}, _DpTpStep(mesh, g, spec["lr"])
            args = (batch(arrays["xb"]), batch(arrays["yb"]))
        else:
            arrays = problem(plan.num_nodes)
            mesh, axis, index = _mesh_and_index(case, world_size)
            if mode == "hybrid":
                step = make_hybrid_train_step(plan, mesh, arrays["inv_deg"], spec["lr"],
                                              device=dev)
            elif mode == "grid2d":
                step = make_grid2d_train_step(plan, mesh, arrays["inv_deg"], spec["lr"],
                                              device=dev)
            else:
                step = makers[mode](plan, mesh, arrays["inv_deg"], spec["lr"], axis=axis,
                                    device=dev)
            x = torch.from_numpy(np.ascontiguousarray(plan.rows_of(arrays["x"], index))).to(dev)
            y = torch.from_numpy(np.ascontiguousarray(plan.rows_of(arrays["y"], index))).to(dev)
            res, args, params = {"index": index}, (x, y), params0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res["setup_s"] = time.perf_counter() - t0
        if spec.get("logits"):
            with torch.no_grad():
                res["logits0"] = step.forward(params, args[0])
        spmm_block.launches, spmm_reference.calls = 0, 0
        comm.traffic.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        losses, ms, host_ms = [], [], []
        for _ in range(spec["steps"]):
            t_host, stop = time.perf_counter(), _timer(dev)
            params, loss = step(params, *args)
            ms.append(stop())
            host_ms.append((time.perf_counter() - t_host) * 1e3)
            losses.append(loss.item())
        res.update(losses=losses, params=params, launches=spmm_block.launches,
                   plain_calls=spmm_reference.calls, ms=ms, host_ms=host_ms,
                   traffic=dict(comm.traffic))
        if dev.type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out[case["name"]] = res
    return out


class _DpTpStep:
    """make_sharded_train_step's step with the graph bound, and its forward."""

    def __init__(self, mesh, g, lr):
        from .sharded import make_sharded_train_step

        self._step, self._mesh, self._g = make_sharded_train_step(mesh, lr), mesh, g

    def __call__(self, params, x, y):
        return self._step(params, self._g, x, y)

    def forward(self, params, x):
        from .sharded import sharded_gcn_forward

        return sharded_gcn_forward(params, self._g, x, self._mesh)


def _dp_tp_setup(shape, graph, params, dev):
    """This rank's part of a dp x tp mesh of `shape` (dp, tp): the mesh,
    its (data, model) coordinates, the graph of graph["indptr"],
    ["indices"], ["n"], ["cfg"] (symmetric) on `dev`, its slices of the
    parameters (the JAX layout) and a function that moves its data rank's
    share of a batch (first axis) to `dev`."""
    from ..models import build_graph
    from .sharded import local_gcn_params, make_mesh

    mesh = make_mesh(None, *shape)
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    g = build_graph(graph["indptr"], graph["indices"], graph["n"], graph["cfg"], symmetric=True,
                    device=dev)

    def batch(arr):
        b = arr.shape[0] // shape[0]
        return torch.from_numpy(np.ascontiguousarray(arr[i * b: (i + 1) * b])).to(dev)

    return mesh, (i, j), g, local_gcn_params(params, mesh, dev), batch


def refusal_cases(rank: int, world_size: int, cases: dict, device: str) -> dict:
    """The message of the ValueError each case raises (None if it does not
    raise). A case is {"call": one of the calls of `_refuse`, "plan": the
    plan it takes, "rows": the rows of the features it is given}."""
    dev = comm.rank_device(device)
    out = {}
    for name, case in cases.items():
        try:
            _refuse(case, dev, world_size)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _refuse(case, dev, world_size):
    from . import grid2d, hybrid, ring, row_sharded, row_sharded_gcn, sharded

    call, plan = case["call"], case.get("plan")
    rows = np.zeros((case.get("rows", 0), 4), np.float32)
    x = torch.from_numpy(rows).to(dev).requires_grad_(True)
    flat = comm.device_mesh((world_size,), ("data",))
    m11 = comm.device_mesh((1, 1), ("host", "chip"))
    g11 = comm.device_mesh((1, 1), ("row", "col"))
    invd = np.zeros(getattr(plan, "num_nodes", 0), np.float32)
    if call == "make_mesh":
        sharded.make_mesh(world_size, dp=2, tp=1)
    elif call == "make_mesh_size":
        sharded.make_mesh(world_size + 1)
    elif call == "axis_order":
        comm.axis_group(m11, ("chip", "host"))
    elif call == "row_sharded_spmm":
        row_sharded.row_sharded_spmm(plan, x, flat)
    elif call == "make_row_sharded_train_step":
        row_sharded_gcn.make_row_sharded_train_step(plan, flat, invd, device=dev)
    elif call == "ring_sharded_spmm":
        ring.ring_sharded_spmm(plan, x, flat)
    elif call == "ring_backward":
        ring.ring_sharded_spmm(plan, x, flat).sum().backward()
    elif call == "make_ring_train_step":
        ring.make_ring_train_step(plan, flat, invd, device=dev)
    elif call == "hybrid_sharded_spmm":
        hybrid.hybrid_sharded_spmm(plan, x, m11)
    elif call == "hybrid_backward":
        hybrid.hybrid_sharded_spmm(plan, x, m11).sum().backward()
    elif call == "make_hybrid_train_step":
        hybrid.make_hybrid_train_step(plan, m11, invd, device=dev)
    elif call == "grid2d_spmm":
        grid2d.grid2d_spmm(plan, x, g11)
    elif call == "grid2d_backward":
        grid2d.grid2d_spmm(plan, x, g11).sum().backward()
    elif call == "make_grid2d_train_step":
        grid2d.make_grid2d_train_step(plan, g11, invd, device=dev)
    else:
        raise KeyError(call)


def fail_on_rank(rank: int, world_size: int, which: int) -> int:
    """Raise on rank `which`; the others wait in a barrier it never joins."""
    if rank == which:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return rank


def sleep_on_rank(rank: int, world_size: int, which: int, seconds: float) -> int:
    """Rank `which` sleeps `seconds` before returning; the others return at once."""
    if rank == which:
        time.sleep(seconds)
    return rank

"""Deployment layer: warm-up at deploy time, exported programs and service
bundles (counterpart of voltrix_spmm_tpu/serve.py, with its names and its
bundle layout; `torch.export` in place of `jax.export`).

A request function (a GCN, GAT, dot-product or flash GAT forward over a
graph's plans, an `ops.spmm` call, int8 included) is exported once with
`export_servable` into a self-contained program: every kernel, K1-K15, is
a registered op (ops/library.py) and stays a node of the program, and the
plans, their work lists and orders, and the parameters the function
closes over become the program's constants. `load_servable` brings the
program back in a process that has never imported the model code; it
imports `ops.library` first, so the ops are registered before
`torch.export.load` reads them. A bundle is a directory with the program,
the plan (`SpmmPlan.save`, packed by default; none for a program whose
plans are ELL plans, which its constants hold) and a metadata file.

    python -c "from voltrix_spmm_tpu_torch.serve import load_bundle; ..."
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any, Callable, Sequence

import torch


def _warm(fn: Callable, args) -> Any:
    """One call of fn(*args) without autograd, synchronized on the card."""
    with torch.no_grad():
        out = fn(*args)
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        torch.cuda.synchronize()
    return out


def aot_compile(fn: Callable, *example_args) -> Callable:
    """Do fn's costly first-call work now, at deploy time, and return fn:
    the kernel builds on the card (nvcc, or the cached library, of every
    kernel of the ops in fn's graph where it has one, as a loaded servable
    does: `library.loaders_of`; else of those the warm call launches), g++
    for the native preprocess, the work lists and orders of the plans fn
    reads (built and kept at their first call, ops/library.py), and one
    warm call on the example arguments. The first request then runs at
    steady-state latency. fn may be a loaded servable."""
    from .ops import library
    from .runtime.native import native_available

    native_available()
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in example_args):
        for load in library.loaders_of(fn):
            load()
    _warm(fn, example_args)
    return fn


def compiled_stats(fn: Callable, *args) -> dict:
    """Capacity-planning numbers of one call of fn(*args): flops
    (`torch.utils.flop_counter`, with each registered op's formula,
    ops/library.py: 2 nnz d for K1-K8, 2 nnz H (dk + dv) for the attention
    forwards K9 and K13), the
    bytes of the tensor arguments and of the output, and the peak device
    bytes the call allocates beyond what was allocated before it (None on
    the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .ops import library  # noqa: F401  (the ops' flop formulas)

    def nbytes(tree) -> int:
        leaves = torch.utils._pytree.tree_leaves(tree)
        return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))

    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    base = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        out = fn(*args)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return {
        "flops": int(counter.get_total_flops()),
        "argument_size_in_bytes": nbytes(args),
        "output_size_in_bytes": nbytes(out),
        "peak_device_bytes": peak,
    }


class _Program(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _dynamic_shapes(example_args, polymorphic_shapes):
    """JAX's spec strings, one per argument ("b, _": axis 0 named b, axis 1
    fixed; None: all fixed), as torch.export dynamic shapes: one
    torch.export.Dim per name, shared across arguments."""
    dims: dict[str, Any] = {}
    specs = []
    for arg, spec in zip(example_args, polymorphic_shapes):
        if spec is None:
            specs.append(None)
            continue
        axes = [a.strip() for a in spec.split(",")]
        if len(axes) != arg.dim():
            raise ValueError(f"spec {spec!r} names {len(axes)} axes of a {arg.dim()}-d argument")
        shape = {}
        for i, name in enumerate(axes):
            if name in ("_", "") or name.isdigit():
                continue
            shape[i] = dims.setdefault(name, torch.export.Dim(name))
        specs.append(shape or None)
    return (tuple(specs),)


def export_servable(fn: Callable, *example_args, polymorphic_shapes=None) -> bytes:
    """fn, traced at the example arguments with `torch.export`, as bytes
    (`torch.export.save`). The tensors fn closes over (plans, parameters)
    become constants of the program. fn is called once first, without
    autograd, so that the plans' work lists and orders are built from the
    real plans and enter the program as constants (ops/library.py), and is
    traced without autograd too, as a request is served: a branch fn takes
    only for a gradient (a GAT's transpose plane) stays out of the
    program. The example arguments are not saved with it.

    polymorphic_shapes: JAX's spec strings, one per argument (e.g.
    ``("b, _",)``): named axes become torch.export.Dim, so one program
    serves every size along them."""
    _warm(fn, example_args)
    dynamic = None
    if polymorphic_shapes is not None:
        if len(polymorphic_shapes) != len(example_args):
            raise ValueError("polymorphic_shapes needs one spec per example argument")
        dynamic = _dynamic_shapes(example_args, polymorphic_shapes)
    with torch.no_grad():  # traced as it is served, without autograd's side of fn
        program = torch.export.export(_Program(fn), tuple(example_args), dynamic_shapes=dynamic)
    # the example request is not part of the program: torch.export.save would
    # store its features in every bundle, beside the constants
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_servable(blob: bytes) -> Callable:
    """The program of `export_servable` as a callable, in any process: the
    kernels' ops are registered first (ops/library.py), then the program
    is loaded; its constants come back on the device they were exported
    on."""
    from .ops import library  # noqa: F401  (registers the voltrix ops)

    return torch.export.load(io.BytesIO(blob)).module()


# --- on-disk service bundle ------------------------------------------------

_BUNDLE_META = "servable.json"
_BUNDLE_BLOB = "servable.pt2"
_BUNDLE_PLAN = "plan.npz"


@dataclasses.dataclass
class ServiceBundle:
    """A directory artifact: exported program + plan + metadata.

    Layout:
      <dir>/servable.pt2   program (torch.export.save)
      <dir>/plan.npz       SpmmPlan.save(packed=...) plan arrays
      <dir>/servable.json  metadata (notes, versions, the device)
    """

    fn: Callable
    plan: Any  # SpmmPlan | None
    meta: dict

    def __call__(self, *args):
        return self.fn(*args)


def _replace_into(path: str, name: str, data, mode: str) -> None:
    tmp = os.path.join(path, f".{name}.tmp.{os.getpid()}")
    with open(tmp, mode) as f:
        if mode == "w":
            json.dump(data, f, indent=2, sort_keys=True)
        else:
            f.write(data)
    os.replace(tmp, os.path.join(path, name))


def save_bundle(path: str, blob: bytes, plan=None, meta: dict | None = None,
                packed: bool = True) -> None:
    """Write a bundle: the program `blob`, the plan (packed sub-tiles by
    default) and `meta`, to which torch's version and, where a card is
    present, its name are added. Each file is replaced atomically."""
    os.makedirs(path, exist_ok=True)
    _replace_into(path, _BUNDLE_BLOB, blob, "wb")
    if plan is not None:
        plan.save(os.path.join(path, _BUNDLE_PLAN), packed=packed)
    meta = dict(meta or {})
    meta.setdefault("torch_version", torch.__version__)
    if torch.cuda.is_available():
        meta.setdefault("device", torch.cuda.get_device_name(0))
    _replace_into(path, _BUNDLE_META, meta, "w")


def load_bundle(path: str) -> ServiceBundle:
    """Read a bundle: the program as a callable (`load_servable`), the plan
    as CPU tensors (`SpmmPlan.load`; `plan.to(device)` moves it) or None,
    and the metadata."""
    with open(os.path.join(path, _BUNDLE_BLOB), "rb") as f:
        fn = load_servable(f.read())
    plan = None
    plan_path = os.path.join(path, _BUNDLE_PLAN)
    if os.path.exists(plan_path):
        from .format.plan import SpmmPlan

        plan = SpmmPlan.load(plan_path)
    with open(os.path.join(path, _BUNDLE_META)) as f:
        meta = json.load(f)
    return ServiceBundle(fn=fn, plan=plan, meta=meta)


__all__: Sequence[str] = ("aot_compile", "compiled_stats", "export_servable", "load_servable",
                          "ServiceBundle", "save_bundle", "load_bundle")

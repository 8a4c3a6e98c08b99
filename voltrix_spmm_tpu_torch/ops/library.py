"""Kernels K1, K2 and K3 as registered torch ops (ROADMAP.md item 5, in
part): ``torch.ops.voltrix.spmm_block``, ``spmm_subtile`` and
``spmm_fused``.

Every call of the three kernels goes through these ops, eager and
exported alike: `spmm_block`, `spmm_subtile` and `spmm_fused` (and through
them `ops.spmm`, `spmm_hybrid`, `spmm_streamed` and `spmm_ad`) build the
operands and call the op. A registered op is what `torch.export` keeps
as one node of the program (serve.py), what a process that loads that
program finds once this module is imported, and what
`torch.utils.flop_counter` counts (2 nnz d a call).

An op takes the feature rows and two plans, each as a list of tensors and
a list of ints (`operands`), since an op's schema holds only tensors and
scalars:

- the plan's tensors: bitmask, hind, window_of_block, the occupancy (K2's
  sub-window bits on the card; the plan's `occ` or nothing on the CPU),
  and the work list of ops/block_spmm.py:plan_walk (tasks, merges; empty
  on the CPU, where no kernel walks it);
- its geometry (`GEOM`): the op it runs under, the config, the sizes and
  the work list's workspace.

The second plan is A^T's (`spmm_ad`), or absent (kind -1). The op's
autograd runs A^T @ grad as the op of the transpose plan's kind over its
operands, with A's as its transpose, so gradients are those of the kernel
path bit for bit. The work lists are built from the real plan at its
first call and kept beside it: trace a program (`torch.export`) only
after one eager call, so that the lists are constants of the program and
never rebuilt inside the traced region (serve.py:export_servable does so).

On a CPU tensor the op runs the kernel's plain version; on a CUDA tensor
it launches the kernel or raises. The features are float32 or bfloat16
(the kernel's bf16 instantiation; the plain versions widen the rows); the
op returns float32 either way. Its gradient runs the float32 kernel on the
cotangent as it arrives and casts once to the features' dtype: behind a
bf16 output the cotangent's values are bf16 already, so this gives the bits
of the JAX package's `spmm_ad` (a bf16 SpMM of its bf16 cotangent), and
behind a float32 output it is the chain rule of the forward.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from ..format.plan import PlanConfig, SpmmPlan
from ..utils import kept_beside
from . import fused_spmm, subtile_spmm
from .block_spmm import Walk, _check_plan, launch_walk, plan_walk
from .fused_spmm import launch_fused, spmm_fused_reference
from .reference import spmm_reference
from .subtile_spmm import spmm_subtile_reference, subtile_walk

NAMESPACE = "voltrix"
KINDS = ("spmm_block", "spmm_subtile", "spmm_fused")  # K1, K2, K3
GEOM = ("kind", "block_h", "block_w", "gather_segment", "block_unroll", "cluster_cols",
        "num_nodes", "num_cols", "num_windows", "total_blocks", "num_edges", "slots", "rows",
        "group_words")
_G = {name: i for i, name in enumerate(GEOM)}
NO_PLAN = -1  # the kind of an absent transpose plan
_SUBTILE = KINDS.index("spmm_subtile")  # K2 reads the occupancy
_GEOMETRY = {"spmm_subtile": subtile_spmm._check_geometry,
             "spmm_fused": fused_spmm._check_geometry}


def kind_of(plan: SpmmPlan) -> str:
    """The op `spmm_ad` runs a plan on: K3 for coverage plans
    (gather_segment >= 8), K2 for column-clustered plans, else K1 (the JAX
    package's rule, ops/autodiff.py)."""
    if plan.config.gather_segment >= 8:
        return "spmm_fused"
    return "spmm_subtile" if plan.config.cluster_cols else "spmm_block"


def operands(plan: SpmmPlan, kind: str, device: torch.device):
    """(tensors, geometry) of `plan` for the op `kind` on `device`'s type,
    built at the first call (on the card with the plan's work list) and
    kept beside the plan's block_ptr."""

    def build():
        empty = torch.zeros(0, dtype=torch.int32, device=plan.device)
        occ, walk = plan.occ, None
        if device.type == "cuda":
            _check_plan(plan, device, kind)
            if kind != "spmm_block":
                _GEOMETRY[kind](plan)
            walk = subtile_walk(plan) if kind == "spmm_subtile" else plan_walk(plan, kind)
            occ = walk.occ
        geom = [KINDS.index(kind), plan.config.block_h, plan.config.block_w,
                plan.config.gather_segment, plan.config.block_unroll,
                int(plan.config.cluster_cols), plan.num_nodes,
                -1 if plan.num_cols is None else plan.num_cols, plan.num_windows,
                plan.total_blocks, plan.num_edges, 0 if walk is None else walk.slots,
                0 if walk is None else walk.rows, 0 if walk is None else walk.group_words]
        tensors = [plan.bitmask, plan.hind, plan.window_of_block,
                   empty if occ is None else occ,
                   empty if walk is None else walk.tasks,
                   empty if walk is None else walk.merges]
        return tensors, geom

    key = ("operands", kind, device.type)
    return kept_beside(plan.block_ptr, key, build, plan.bitmask, plan.hind,
                       plan.window_of_block, plan.occ)


def no_plan(tensors: list[Tensor], geom: list[int]):
    """The operands of an absent transpose plan (kind -1; the op's gradient
    then raises): the forward plan's tensors, so the op holds no new
    constant."""
    return tensors, [NO_PLAN] + geom[1:]


@functools.lru_cache(maxsize=64)
def _config(block_h: int, block_w: int, seg: int, unroll: int, cluster: int) -> PlanConfig:
    return PlanConfig(block_h, block_w, seg, unroll, bool(cluster))


def _plan_of(tensors: list[Tensor], geom: list[int]) -> SpmmPlan:
    bitmask, hind, wob, occ, _, _ = tensors
    g = geom
    return SpmmPlan(
        bitmask=bitmask, hind=hind, window_of_block=wob, block_ptr=None,
        config=_config(*g[_G["block_h"]:_G["cluster_cols"] + 1]),
        num_nodes=g[_G["num_nodes"]], num_edges=g[_G["num_edges"]],
        num_windows=g[_G["num_windows"]], total_blocks=g[_G["total_blocks"]],
        num_cols=None if g[_G["num_cols"]] < 0 else g[_G["num_cols"]],
        occ=occ if occ.numel() else None,
    )


def _walk_of(tensors: list[Tensor], geom: list[int]) -> Walk:
    occ, tasks, merges = tensors[3:]
    return Walk(tasks=tasks, merges=merges, slots=geom[_G["slots"]], rows=geom[_G["rows"]],
                cut_windows=0, occ=occ if geom[_G["kind"]] == _SUBTILE else None,
                group_words=geom[_G["group_words"]])


def _run(kind: str, feat: Tensor, tensors: list[Tensor], geom: list[int]) -> Tensor:
    """The op's body: the plain version on the CPU, the kernel on the card;
    float32 (num_nodes, D)."""
    plan = _plan_of(tensors, geom)
    if feat.device.type == "cpu":
        plain = {"spmm_block": spmm_reference, "spmm_subtile": spmm_subtile_reference,
                 "spmm_fused": spmm_fused_reference}[kind]
        return plain(plan, feat, torch.float32)
    from . import block_spmm

    out = torch.empty(plan.num_nodes, feat.shape[1], dtype=torch.float32, device=feat.device)
    if out.numel():
        walk = _walk_of(tensors, geom)
        module = {"spmm_block": block_spmm, "spmm_subtile": subtile_spmm,
                  "spmm_fused": fused_spmm}[kind]
        bf16 = feat.dtype == torch.bfloat16
        library = module.load_bf16_library() if bf16 else module.load_library()
        if kind == "spmm_fused":
            launch_fused(library, plan, walk, feat, out)
        else:
            launch_walk(kind, library, plan, feat, out, walk)
        wrapper = getattr(module, kind)
        wrapper.launches += 1
        if bf16:
            wrapper.launches_bf16 += 1
    return out


_LIB = torch.library.Library(NAMESPACE, "DEF")
SCHEMA = "(Tensor feat, Tensor[] plan, int[] geom, Tensor[] plan_t, int[] geom_t) -> Tensor"


def _define(kind: str):
    """Register the op `kind`: its schema, one body for the CPU and the card,
    its fake (shape and dtype only), its autograd and its flop formula.
    torch.library's low-level registration (Library.define and .impl)
    takes the same fake and autograd registrations as
    torch.library.custom_op, whose Python wrapper adds host time to every
    call of these list-taking schemas."""
    _LIB.define(kind + SCHEMA)

    def body(feat, plan, geom, plan_t, geom_t):
        return _run(kind, feat, plan, geom)

    for key in ("CPU", "CUDA"):
        _LIB.impl(kind, body, key)

    def fake(feat, plan, geom, plan_t, geom_t):
        return feat.new_empty(geom[_G["num_nodes"]], feat.shape[1], dtype=torch.float32)

    torch.library.register_fake(f"{NAMESPACE}::{kind}", fake, lib=_LIB)

    def setup_context(ctx, inputs, output):
        feat, plan, geom, plan_t, geom_t = inputs
        ctx.n, ctx.geom, ctx.geom_t, ctx.dtype = len(plan), geom, geom_t, feat.dtype
        ctx.save_for_backward(*plan, *plan_t)

    def backward(ctx, grad):
        if ctx.geom_t[_G["kind"]] == NO_PLAN:
            raise RuntimeError(
                f"{NAMESPACE}::{kind} was called without the transpose plan: "
                "differentiate through spmm_ad(plan, plan_t, feat)")
        saved = list(ctx.saved_tensors)
        plan, plan_t = saved[:ctx.n], saved[ctx.n:]
        transpose = getattr(torch.ops.voltrix, KINDS[ctx.geom_t[_G["kind"]]]).default
        dfeat = transpose(grad.contiguous(), plan_t, ctx.geom_t, plan, ctx.geom)
        return dfeat.to(ctx.dtype), [None] * len(plan), None, [None] * len(plan_t), None

    torch.library.register_autograd(f"{NAMESPACE}::{kind}", backward,
                                    setup_context=setup_context, lib=_LIB)
    registered = getattr(torch.ops.voltrix, kind).default

    @register_flop_formula(getattr(torch.ops.voltrix, kind))
    def _(feat_shape, plan, geom, plan_t, geom_t, out_shape=None, **kwargs) -> int:
        return 2 * geom[_G["num_edges"]] * feat_shape[1]

    return registered


spmm_block_op = _define("spmm_block")
spmm_subtile_op = _define("spmm_subtile")
spmm_fused_op = _define("spmm_fused")
_OPS = {"spmm_block": spmm_block_op, "spmm_subtile": spmm_subtile_op,
        "spmm_fused": spmm_fused_op}


def call(kind: str, plan: SpmmPlan, feat: Tensor, plan_t: SpmmPlan | None = None) -> Tensor:
    """The op `kind` on `plan` and `feat` (checked by the caller), with
    plan_t's operands for feat's gradient when autograd will take it
    (plan_t runs under its own kind, `kind_of`); float32 (num_nodes, D)."""
    ops, geom = operands(plan, kind, feat.device)
    if plan_t is None or not (feat.requires_grad and torch.is_grad_enabled()):
        # no gradient to take: plan_t is not read, and may stay on the host
        ops_t, geom_t = no_plan(ops, geom)
    else:
        ops_t, geom_t = operands(plan_t, kind_of(plan_t), feat.device)
    return _OPS[kind](feat, ops, geom, ops_t, geom_t)

"""Every kernel of the port, K1-K15, as a registered torch op in the
``voltrix`` namespace (ROADMAP.md item 5):

| op | kernel | gradient (`register_autograd`) |
|---|---|---|
| `spmm_block`, `spmm_subtile`, `spmm_fused` | K1, K2, K3 | A^T @ grad, plan_t's kind's op |
| `spmm_weighted` | K4 | feat: K4 over plan_t's plane; values: K5 |
| `spmm_dvalues` | K5 | none (a backward kernel) |
| `spmm_int8` | K8 | raises: the JAX package's `spmm_pallas_int8` has none |
| `spmm_attention` | K9 | K11 over plan and K12 over plan_t, else K10 summed |
| `attention_bwd` | K10 | none |
| `attention_dq`, `attention_dkv` | K11, K12 (K14's, K15's kernels at one head) | none |
| `spmm_attention_mh` | K13 | K14 over plan, K15 over plan_t |
| `attention_mh_dq`, `attention_mh_dkv` | K14, K15 | none |
| `spmm_ell` | K6 | feat: K6 over plan_t's lanes; vals: K7 |
| `spmm_ell_dvals` | K7 | the SDDMM's: K6 over plan and over plan_t |

Every call of these kernels goes through its op, eager and exported
alike: the wrappers (`spmm_block`, `spmm_weighted`, `spmm_ell`,
`spmm_attention_mh_ad` and the rest) check their arguments, build the
operands and call the op. A registered op is what `torch.export` keeps as
one node of the program (serve.py), what a process that loads that
program finds once this module is imported, and what
`torch.utils.flop_counter` counts (each op's formula below).

An op takes its tensors (features, values, q, k, v) as plain `Tensor`
arguments and each plan as a list of tensors and a list of ints
(`operands`), since an op's schema holds only tensors and scalars:

- the plan's tensors: an `SpmmPlan`'s bitmask, hind, window_of_block, the
  occupancy (K2's sub-window bits on the card; the plan's `occ` or nothing
  on the CPU) and the work list of ops/block_spmm.py:plan_walk (tasks,
  merges; empty on the CPU, where no kernel walks it), with K10's source
  order (`plan_lane_sources`) after them; an `EllPlan`'s hind, erow and
  window_of_block, with K6's row order (`plan_rows`) or K7's source order
  (`plan_sources`) after them on the card;
- its geometry (`GEOM`): the op it runs under, the config, the sizes and
  the work list's workspace.

The operands of the kernels a gradient runs come beside the forward's:
the transpose plan's (kind -1, `no_plan`, where there is none), and, for
K4, K6, K7, K9 and K13, the other kernels' operands over the same plan.
They are built only where autograd will take the gradient, so an
exported request holds none of them. The operands are built from the
real plan at its first call and kept beside it (`utils.kept_beside`):
trace a program (`torch.export`) only after one eager call, so that the
work lists and orders are constants of the program and never rebuilt
inside the traced region (serve.py:export_servable does so).

On a CPU tensor an op runs the kernel's plain version; on a CUDA tensor
it launches the kernel or raises, and the kernel's `launches` count goes
up there, in the op's body, and nowhere else (not in the fake, nor while
tracing). The ops return float32; the wrappers cast. K1-K4 and K6 read
float32, bfloat16 or float16 features, K4 a value plane of any of those
types (the 16-bit instantiations; the plain versions widen them), and K8
the codes of float32, bf16 or float16 rows. K1-K3's gradient runs
the float32 kernel on the cotangent as it arrives and casts once to the
features' dtype: behind a bf16 or float16 output the cotangent's values
are of that type already, so this gives the bits of the JAX package's
`spmm_ad` (a 16-bit SpMM of its 16-bit cotangent: the 16-bit kernels are
the float32 one on the widened rows), and behind a float32 output it is
the chain rule of the forward. K4's casts the
cotangent to the features' dtype first, as JAX's rule does. K9's and
K13's ops take a compute_dtype (float32, or bfloat16 or float16:
csrc/attn_fwd_bf16.cu), which their gradient passes to the backward ops
(K10-K12, K14, K15), whose own compute_dtype (float32 or bfloat16; float16
raises) launches their kernels' compute variants.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from ..format.ell import EllPlan
from ..format.plan import PlanConfig, SpmmPlan
from ..utils import kept_beside
from . import (attention, attention_mh, block_spmm, ell, fused_spmm, quant, subtile_spmm,
               weighted)
from ._attn_core import (_dkv_kernel, _dq_kernel, check_plan_arrays, compute_bwd,
                         compute_half, fwd_half_kernel, fwd_half_library)
from .block_spmm import (HALF_DTYPES, Walk, _check_plan, acc_width, count_launch, launch_walk,
                         library_for)
from .fused_spmm import launch_fused, spmm_fused_reference
from .reference import spmm_reference
from .subtile_spmm import spmm_subtile_reference, subtile_walk

NAMESPACE = "voltrix"
KINDS = ("spmm_block", "spmm_subtile", "spmm_fused",  # K1, K2, K3
         "spmm_weighted", "spmm_dvalues", "spmm_int8",  # K4, K5, K8
         "spmm_attention", "attention_bwd", "attention_dq", "attention_dkv",  # K9-K12
         "spmm_attention_mh", "attention_mh_dq", "attention_mh_dkv",  # K13-K15
         "spmm_ell", "spmm_ell_dvals")  # K6, K7
GEOM = ("kind", "block_h", "block_w", "gather_segment", "block_unroll", "cluster_cols",
        "num_nodes", "num_cols", "num_windows", "total_blocks", "num_edges", "slots", "rows",
        "group_words")
_G = {name: i for i, name in enumerate(GEOM)}
NO_PLAN = -1  # the kind of an absent plan
_SUBTILE = KINDS.index("spmm_subtile")  # K2 reads the occupancy
_GEOMETRY = {"spmm_subtile": subtile_spmm._check_geometry,
             "spmm_fused": fused_spmm._check_geometry}
_ATTENTION = ("spmm_attention", "attention_bwd", "attention_dq", "attention_dkv",
              "spmm_attention_mh", "attention_mh_dq", "attention_mh_dkv")
# the wrapper whose `launches` K11, K12, K14 and K15 count, by op
_ENTRY = {"attention_dq": attention.attention_dq, "attention_dkv": attention.attention_dkv,
          "attention_mh_dq": attention_mh.attention_mh_dq,
          "attention_mh_dkv": attention_mh.attention_mh_dkv}
# the kernel libraries each op launches (aot_compile loads them)
LOADERS = {
    "spmm_block": (block_spmm.load_library,), "spmm_subtile": (subtile_spmm.load_library,),
    "spmm_fused": (fused_spmm.load_library,), "spmm_weighted": (weighted.load_library,),
    "spmm_dvalues": (weighted.load_dvalues_library,), "spmm_int8": (quant.load_library,),
    "spmm_attention": (attention.load_fwd_library,), "attention_bwd": (attention.load_bwd_library,),
    "attention_dq": (attention_mh.load_dq_library,),
    "attention_dkv": (attention_mh.load_dkv_library,),
    "spmm_attention_mh": (attention.load_mh_fwd_library,),
    "attention_mh_dq": (attention_mh.load_dq_library,),
    "attention_mh_dkv": (attention_mh.load_dkv_library,),
    "spmm_ell": (ell.load_library,), "spmm_ell_dvals": (ell.load_dvals_library,),
}


def kind_of(plan: SpmmPlan) -> str:
    """The op `spmm_ad` runs a plan on: K3 for coverage plans
    (gather_segment >= 8), K2 for column-clustered plans, else K1 (the JAX
    package's rule, ops/autodiff.py)."""
    if plan.config.gather_segment >= 8:
        return "spmm_fused"
    return "spmm_subtile" if plan.config.cluster_cols else "spmm_block"


def _geom(plan, kind: str, slots: int = 0, rows: int = 0, group_words: int = 0) -> list[int]:
    cfg = plan.config
    return [KINDS.index(kind), cfg.block_h, cfg.block_w, cfg.gather_segment, cfg.block_unroll,
            int(cfg.cluster_cols), plan.num_nodes, -1 if plan.num_cols is None else plan.num_cols,
            plan.num_windows, plan.total_blocks, plan.num_edges, slots, rows, group_words]


def operands(plan: SpmmPlan, kind: str, device: torch.device):
    """(tensors, geometry) of `plan` for the op `kind` on `device`'s type,
    built at the first call (on the card with the kernel's work list) and
    kept beside the plan's block_ptr."""

    def build():
        empty = torch.zeros(0, dtype=torch.int32, device=plan.device)
        occ, walk, extra = plan.occ, None, []
        if device.type == "cuda":
            _check_plan(plan, device, kind)
            if kind in _GEOMETRY:
                _GEOMETRY[kind](plan)
            if kind in _ATTENTION:
                check_plan_arrays(plan, device, kind)
            if kind == "spmm_subtile":
                walk = subtile_walk(plan)
            else:  # K9's and K13's with a share slot a piece (attention_walk)
                walk = attention.attention_walk(plan, kind)
            occ = walk.occ
        if kind == "attention_bwd":  # K10's sum, on either device
            s = attention.plan_lane_sources(plan)
            extra = [s.lane, s.lane_slot, s.slot_lane, s.offsets]
        geom = _geom(plan, kind, *((0, 0, 0) if walk is None else
                                   (walk.slots, walk.rows, walk.group_words)))
        tensors = [plan.bitmask, plan.hind, plan.window_of_block,
                   empty if occ is None else occ,
                   empty if walk is None else walk.tasks,
                   empty if walk is None else walk.merges, *extra]
        return tensors, geom

    # keyed by the kernel's piece limits too, as its work list is (a sweep
    # that moves them gets operands of its own)
    key = ("operands", kind, device.type, block_spmm.PIECE_BLOCKS.get(kind),
           block_spmm.PIECE_WORK.get(kind))
    return kept_beside(plan.block_ptr, key, build, plan.bitmask, plan.hind,
                       plan.window_of_block, plan.occ)


def ell_operands(plan: EllPlan, kind: str, device: torch.device, wide: bool = False):
    """(tensors, geometry) of the ELL plan for K6 ("spmm_ell", with its row
    order `plan_rows` on the card) or K7 ("spmm_ell_dvals", with its source
    order `plan_sources` on the card where `wide`), built at the first call
    and kept beside the plan's block_ptr (the operands hold the lane arrays,
    so these may not be the anchor, or the two would never be freed)."""

    def build():
        extra, slots = [], 0
        if device.type == "cuda" and kind == "spmm_ell":
            rows = ell.plan_rows(plan)
            extra, slots = [rows.src, rows.lane, rows.items, rows.merges], rows.slots
        elif device.type == "cuda" and wide:
            s = ell.plan_sources(plan)
            extra = [s.pieces, s.lane, s.src, s.row]
        return [plan.hind, plan.erow, plan.window_of_block, *extra], _geom(plan, kind, slots)

    key = ("operands", kind, device.type, wide, ell.PIECE_LANES, ell.DVALS_PIECE_LANES)
    return kept_beside(plan.block_ptr, key, build, plan.hind, plan.erow, plan.window_of_block)


def no_plan(tensors: list[Tensor], geom: list[int]):
    """The operands of an absent plan (kind -1; a gradient that needs it
    raises): the forward plan's tensors, so the op holds no new
    constant."""
    return tensors, [NO_PLAN] + geom[1:]


def _absent(geom: list[int]) -> bool:
    return geom[_G["kind"]] == NO_PLAN


@functools.lru_cache(maxsize=64)
def _config(block_h: int, block_w: int, seg: int, unroll: int, cluster: int) -> PlanConfig:
    return PlanConfig(block_h, block_w, seg, unroll, bool(cluster))


def _sizes(geom: list[int]) -> dict:
    g = geom
    return dict(config=_config(*g[_G["block_h"]:_G["cluster_cols"] + 1]),
                num_nodes=g[_G["num_nodes"]], num_edges=g[_G["num_edges"]],
                num_windows=g[_G["num_windows"]], total_blocks=g[_G["total_blocks"]],
                num_cols=None if g[_G["num_cols"]] < 0 else g[_G["num_cols"]])


def _plan_of(tensors: list[Tensor], geom: list[int], values=None) -> SpmmPlan:
    bitmask, hind, wob, occ = tensors[:4]
    return SpmmPlan(bitmask=bitmask, hind=hind, window_of_block=wob, block_ptr=None,
                    occ=occ if occ.numel() else None, values=values, **_sizes(geom))


def _walk_of(tensors: list[Tensor], geom: list[int]) -> Walk:
    occ, tasks, merges = tensors[3:6]
    return Walk(tasks=tasks, merges=merges, slots=geom[_G["slots"]], rows=geom[_G["rows"]],
                cut_windows=0, occ=occ if geom[_G["kind"]] == _SUBTILE else None,
                group_words=geom[_G["group_words"]])


def _ell_of(tensors: list[Tensor], geom: list[int], vals=None) -> EllPlan:
    hind, erow, wob = tensors[:3]
    return EllPlan(hind=hind, erow=erow, vals=vals, window_of_block=wob, block_ptr=None,
                   edge_lane=None, lane_edge=None, **_sizes(geom))


_LIB = torch.library.Library(NAMESPACE, "DEF")


def _register(name: str, schema: str, body, fake, flops, backward=None, setup_context=None):
    """Register the op `name`: its schema, one body for the CPU and the
    card, its fake (shapes and dtypes from the geometry and the inputs'
    shapes alone), its autograd where it has a gradient (`_autograd`), and
    its flop formula. torch.library's low-level registration
    (Library.define and .impl) takes the same fake registration as
    torch.library.custom_op, whose Python wrapper adds host time to every
    call of these list-taking schemas."""
    _LIB.define(name + schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, body, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(torch.ops.voltrix, name)
    if backward is not None:
        _autograd(name, packet.default, backward, setup_context)
    register_flop_formula(packet)(flops)
    return packet.default


def _autograd(name: str, op, backward, setup_context) -> None:
    """The op's gradient, registered as an autograd.Function on the
    Autograd key (the dispatcher's place for one): `setup_context(ctx,
    inputs, output)` and `backward(ctx, *grads)` as
    torch.library.register_autograd takes them, a None in place of each
    list's gradients. register_autograd's own wrapper flattens the tensor
    lists of every call with pytree, host time that made path E's training
    step (54 calls) 1.66x slower on the H100 (PERF.md); the plan operands
    never take a gradient, so the Function passes the lists through whole.
    Below it, and where no tensor argument needs a gradient, the op runs its
    body as it is."""

    class Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            with torch._C._AutoDispatchBelowAutograd():
                out = op(*args)
            setup_context(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, *grads):
            return tuple(None if isinstance(g, list) else g for g in backward(ctx, *grads))

    Function.__name__ = f"{name}_autograd"

    def impl(*args):
        if torch.is_grad_enabled() and any(isinstance(a, Tensor) and a.requires_grad
                                           for a in args):
            return Function.apply(*args)
        with torch._C._AutoDispatchBelowAutograd():
            return op(*args)

    _LIB.impl(name, impl, "Autograd")


def _needs(*tensors) -> bool:
    """Whether autograd will take a gradient of a call on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _f32(*shape, like: Tensor) -> Tensor:
    return like.new_empty(*shape, dtype=torch.float32)


# --- K1, K2, K3: the binary SpMM ------------------------------------------------

def _run(kind: str, feat: Tensor, tensors: list[Tensor], geom: list[int]) -> Tensor:
    """The body of K1-K3's ops: the plain version on the CPU, the kernel on
    the card; float32 (num_nodes, D)."""
    plan = _plan_of(tensors, geom)
    if feat.device.type == "cpu":
        plain = {"spmm_block": spmm_reference, "spmm_subtile": spmm_subtile_reference,
                 "spmm_fused": spmm_fused_reference}[kind]
        return plain(plan, feat, torch.float32)
    out = torch.empty(plan.num_nodes, feat.shape[1], dtype=torch.float32, device=feat.device)
    if out.numel():
        walk = _walk_of(tensors, geom)
        module = {"spmm_block": block_spmm, "spmm_subtile": subtile_spmm,
                  "spmm_fused": fused_spmm}[kind]
        library = library_for(module, feat.dtype)
        if kind == "spmm_fused":
            launch_fused(library, plan, walk, feat, out)
        else:
            launch_walk(kind, library, plan, feat, out, walk)
        count_launch(getattr(module, kind), feat.dtype)
    return out


SCHEMA = "(Tensor feat, Tensor[] plan, int[] geom, Tensor[] plan_t, int[] geom_t) -> Tensor"


def _define(kind: str):
    """K1's, K2's or K3's op: out = A @ feat, 2 nnz d flops; gradient A^T @
    grad through the op of plan_t's kind."""

    def body(feat, plan, geom, plan_t, geom_t):
        return _run(kind, feat, plan, geom)

    def fake(feat, plan, geom, plan_t, geom_t):
        return _f32(geom[_G["num_nodes"]], feat.shape[1], like=feat)

    def setup_context(ctx, inputs, output):
        feat, plan, geom, plan_t, geom_t = inputs
        ctx.n, ctx.geom, ctx.geom_t, ctx.dtype = len(plan), geom, geom_t, feat.dtype
        ctx.save_for_backward(*plan, *plan_t)

    def backward(ctx, grad):
        if _absent(ctx.geom_t):
            raise RuntimeError(
                f"{NAMESPACE}::{kind} was called without the transpose plan: "
                "differentiate through spmm_ad(plan, plan_t, feat)")
        saved = list(ctx.saved_tensors)
        plan, plan_t = saved[:ctx.n], saved[ctx.n:]
        transpose = _OPS[KINDS[ctx.geom_t[_G["kind"]]]]
        dfeat = transpose(grad.contiguous(), plan_t, ctx.geom_t, plan, ctx.geom)
        return dfeat.to(ctx.dtype), [None] * len(plan), None, [None] * len(plan_t), None

    def flops(feat_shape, plan, geom, plan_t, geom_t, out_shape=None, **kwargs) -> int:
        """2 nnz d: a multiply and an add for each edge and column."""
        return 2 * geom[_G["num_edges"]] * feat_shape[1]

    return _register(kind, SCHEMA, body, fake, flops, backward, setup_context)


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
    if plan_t is None or not _needs(feat):
        # no gradient to take: plan_t is not read, and may stay on the host
        ops_t, geom_t = no_plan(ops, geom)
    else:
        ops_t, geom_t = operands(plan_t, kind_of(plan_t), feat.device)
    return _OPS[kind](feat, ops, geom, ops_t, geom_t)


def _nnz_flops(feat_shape, other_shape, plan, geom, *args, out_shape=None, **kwargs) -> int:
    """K4-K7's: 2 nnz d, a multiply and an add for each edge (the plan's
    num_edges) and column (feat's d; K5's and K7's dot products are as
    wide)."""
    return 2 * geom[_G["num_edges"]] * feat_shape[1]


# --- K4 and K5: the weighted SpMM and its value gradient -------------------------

def _weighted_body(feat, values, plan, geom, plan_dv, geom_dv, values_t, plan_t, geom_t):
    p = _plan_of(plan, geom, values)
    if feat.device.type == "cpu":
        return weighted.spmm_weighted_reference(p, feat, torch.float32)
    return weighted.k4_kernel(p, _walk_of(plan, geom), feat)


def _weighted_fake(feat, values, plan, geom, *args):
    return _f32(geom[_G["num_nodes"]], feat.shape[1], like=feat)


def _weighted_setup(ctx, inputs, output):
    feat, values, plan, geom, plan_dv, geom_dv, values_t, plan_t, geom_t = inputs
    ctx.geoms, ctx.dtype, ctx.has_t = (geom_dv, geom_t), feat.dtype, values_t is not None
    ctx.sizes = (len(plan), len(plan_dv))
    ctx.save_for_backward(feat, *([values_t] if ctx.has_t else []), *plan_dv, *plan_t)


def _weighted_backward(ctx, grad):
    """K4's gradient: feat's, K4 over plan_t's plane; the plane's, K5 over
    plan."""
    geom_dv, geom_t = ctx.geoms
    saved = list(ctx.saved_tensors)
    feat, values_t = saved[0], saved[1] if ctx.has_t else None
    rest = saved[1 + ctx.has_t:]
    n, n_dv = ctx.sizes
    plan_dv, plan_t = rest[:n_dv], rest[n_dv:]
    grad = grad.contiguous()
    dfeat = dvalues = None
    if ctx.needs_input_grad[0]:
        if values_t is None or _absent(geom_t):
            raise ValueError(weighted.NEEDS_PLANE_T)
        # K4 over the cotangent in the features' dtype, as JAX's rule casts
        # it (weighted.py:334-336): bf16 rows for bf16 features
        dfeat = spmm_weighted_op(grad.to(ctx.dtype), values_t, plan_t, geom_t,
                                 *no_plan(plan_t, geom_t), None,
                                 *no_plan(plan_t, geom_t)).to(ctx.dtype)
    if ctx.needs_input_grad[1]:
        if _absent(geom_dv):
            raise RuntimeError(f"{NAMESPACE}::spmm_weighted was called without K5's operands: "
                               "differentiate through spmm_weighted_ad")
        # K5 on float32 operands, as JAX widens both (weighted.py:221, :226);
        # autograd casts the float32 plane to the plane's dtype
        dvalues = spmm_dvalues_op(feat.float(), grad, plan_dv, geom_dv)
    return (dfeat, dvalues, [None] * n, None, [None] * n_dv, None, None, [None] * len(plan_t),
            None)


spmm_weighted_op = _register(
    "spmm_weighted",
    "(Tensor feat, Tensor values, Tensor[] plan, int[] geom, Tensor[] plan_dv, int[] geom_dv, "
    "Tensor? values_t, Tensor[] plan_t, int[] geom_t) -> Tensor",
    _weighted_body, _weighted_fake, _nnz_flops, _weighted_backward, _weighted_setup)


def _dvalues_body(feat, g, plan, geom):
    p = _plan_of(plan, geom)
    if feat.device.type == "cpu":
        return weighted.spmm_weighted_dvalues_reference(p, feat, g)
    return weighted.k5_kernel(p, _walk_of(plan, geom), feat, g)


def _dvalues_fake(feat, g, plan, geom):
    return _f32(geom[_G["total_blocks"]], geom[_G["block_h"]], geom[_G["block_w"]], like=feat)


spmm_dvalues_op = _register(
    "spmm_dvalues", "(Tensor feat, Tensor g, Tensor[] plan, int[] geom) -> Tensor",
    _dvalues_body, _dvalues_fake, _nnz_flops)


def call_weighted(plan: SpmmPlan, feat: Tensor, plan_t: SpmmPlan | None = None) -> Tensor:
    """K4's op on `plan` (its value plane) and `feat` (checked by the
    caller), with K5's operands where autograd takes the plane's gradient
    and plan_t's (its plane) where it takes feat's; float32 (num_nodes, D)."""
    dev = feat.device
    ops, geom = operands(plan, "spmm_weighted", dev)
    ops_dv, geom_dv = (operands(plan, "spmm_dvalues", dev) if _needs(plan.values)
                       else no_plan(ops, geom))
    values_t, (ops_t, geom_t) = None, no_plan(ops, geom)
    if plan_t is not None and _needs(feat):
        if plan_t.values is not None and dev.type == "cuda":
            cfg = plan_t.config
            plane = (weighted.FEAT_DTYPES, (plan_t.total_blocks, cfg.block_h, cfg.block_w))
            weighted._check_kernel_args(plan_t, "spmm_weighted_ad", {"values": plane}, feat,
                                        dtypes=weighted.FEAT_DTYPES)
        values_t, (ops_t, geom_t) = plan_t.values, operands(plan_t, "spmm_weighted", dev)
    return spmm_weighted_op(feat, plan.values, ops, geom, ops_dv, geom_dv, values_t, ops_t, geom_t)


def call_dvalues(plan: SpmmPlan, feat: Tensor, g: Tensor) -> Tensor:
    """K5's op (arguments checked by the caller): float32 (total_blocks,
    block_h, block_w)."""
    ops, geom = operands(plan, "spmm_dvalues", feat.device)
    return spmm_dvalues_op(feat, g, ops, geom)


# --- K8: the int8 SpMM -----------------------------------------------------------------

def _int8_body(rows, scale, plan, geom, d, rows_dtype=torch.float32):
    p = _plan_of(plan, geom)
    if rows.device.type == "cpu":
        return quant.int8_rows_reference(p, rows, scale, d)
    return quant.k8_kernel(p, _walk_of(plan, geom), rows, scale, d, rows_dtype)


def _int8_fake(rows, scale, plan, geom, d, rows_dtype=torch.float32):
    return _f32(geom[_G["num_nodes"]], d, like=scale)


def _int8_flops(rows_shape, scale_shape, plan, geom, d, rows_dtype=torch.float32,
                out_shape=None, **kwargs) -> int:
    """2 nnz d: a multiply and an add for each edge and column (the
    dequantization's 2 a row value aside)."""
    return 2 * geom[_G["num_edges"]] * d


def _int8_backward(ctx, grad):
    raise RuntimeError(f"{NAMESPACE}::spmm_int8 has no gradient, as the JAX package's "
                       "spmm_pallas_int8 has none: train through spmm_ad")


spmm_int8_op = _register(
    "spmm_int8", "(Tensor rows, Tensor scale, Tensor[] plan, int[] geom, int d, "
    "ScalarType rows_dtype=float) -> Tensor",
    _int8_body, _int8_fake, _int8_flops, _int8_backward, lambda ctx, inputs, output: None)


def call_int8(plan: SpmmPlan, rows: Tensor, scale: Tensor, d: int,
              rows_dtype=torch.float32) -> Tensor:
    """K8's op on int8 rows and their scales from `quant.quantize_padded`
    (`rows_dtype`: the type of the rows they were quantized from, a 16-bit
    one counted apart by K8): float32 (num_nodes, d)."""
    ops, geom = operands(plan, "spmm_int8", rows.device)
    return spmm_int8_op(rows, scale, ops, geom, d, rows_dtype)


# --- K9-K15: fused attention ---------------------------------------------------------

def _attn_flops(q_shape, k_shape, v_shape, plan, geom, *args, out_shape=None, **kwargs) -> int:
    """2 nnz H (dk + dv): each edge's score (dk) and its share of the
    output (dv), for each head."""
    heads = 1 if len(q_shape) == 2 else q_shape[0]
    return 2 * geom[_G["num_edges"]] * heads * (q_shape[-1] + v_shape[-1])


def _bwd_flops(q_shape, k_shape, v_shape, g_shape, lse_shape, d_shape, plan, geom, *args,
               out_shape=None, **kwargs) -> int:
    """2 nnz H (2 dk + 2 dv) for K12 and K15 (each edge's score and dO . v
    recomputed, its terms of dk and dv), 2 nnz H (2 dk + dv) for K11 and
    K14 (the score, dO . v, its term of dq)."""
    dk, dv = q_shape[-1], v_shape[-1]
    dkv = KINDS[geom[_G["kind"]]] in ("attention_dkv", "attention_mh_dkv")
    return 2 * geom[_G["num_edges"]] * q_shape[0] * (2 * dk + (2 if dkv else 1) * dv)


def _k10_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape, g_shape, plan, geom, *args,
               out_shape=None, **kwargs) -> int:
    """2 nnz (3 dk + 2 dv): each edge's score, dO . v, and its terms of dq,
    dk and dv."""
    return 2 * geom[_G["num_edges"]] * (3 * q_shape[-1] + 2 * v_shape[-1])


def _sources_of(tensors: list[Tensor]):
    lane, lane_slot, slot_lane, offsets = tensors[6:10]
    return attention.LaneSources(lane=lane, lane_slot=lane_slot, slot_lane=slot_lane,
                                 offsets=offsets)


def _attention_body(q, k, v, plan, geom, plan_dq, geom_dq, plan_dkv, geom_dkv, scale, slope,
                    compute_dtype=torch.float32):
    p = _plan_of(plan, geom)
    half = compute_half(compute_dtype)
    if q.device.type == "cpu":
        out, lse = attention.spmm_attention_reference(p, q, k, v, scale=scale,
                                                      negative_slope=slope, return_stats=True,
                                                      out_dtype=torch.float32,
                                                      compute_dtype=compute_dtype)
        return out.contiguous(), lse.contiguous()
    walk = _walk_of(plan, geom)
    if half is not None:  # K13's compute kernel at one head, on K9's work list and count
        out, lse = fwd_half_kernel(attention.spmm_attention, p, walk, q[None], k[None], v[None],
                                   scale, slope, None, 1, acc_width(v.shape[1]), half)
        return out[0], lse[0]
    return attention._fwd_kernel(p, walk, q, k, v, scale, slope)


def _attention_fake(q, k, v, plan, geom, *args):
    padded = geom[_G["num_windows"]] * geom[_G["block_h"]]
    return _f32(q.shape[0], v.shape[1], like=q), _f32(padded, like=q)


def _attention_setup(ctx, inputs, output):
    q, k, v, plan, geom, plan_dq, geom_dq, plan_dkv, geom_dkv, scale, slope, *flag = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.geoms, ctx.scale, ctx.slope = (geom_dq, geom_dkv), scale, slope
    ctx.compute = flag[0] if flag else torch.float32
    ctx.sizes = (len(plan), len(plan_dq))
    ctx.save_for_backward(q, k, v, out, lse, *plan_dq, *plan_dkv)


def _attention_backward(ctx, g, _g_lse):
    """K9's gradient: K10 summed (geom_dq of attention_bwd), or K11 over
    plan and K12 over plan_t, at the forward's compute_dtype. lse carries
    none."""
    geom_dq, geom_dkv = ctx.geoms
    q, k, v, out, lse, *rest = ctx.saved_tensors
    n, n_dq = ctx.sizes
    plan_dq, plan_dkv = rest[:n_dq], rest[n_dq:]
    g = g.float().contiguous()
    dq = dk = dv = None
    if _absent(geom_dq):
        raise RuntimeError(f"{NAMESPACE}::spmm_attention was called without its gradient's "
                           "operands: differentiate through spmm_attention_ad")
    if KINDS[geom_dq[_G["kind"]]] == "attention_bwd":
        dq, dk, dv = attention_bwd_op(q, k, v, out, lse, g, plan_dq, geom_dq, ctx.scale,
                                      ctx.slope, True, ctx.compute)
    else:
        d_row = (g * out.float()).sum(-1)  # D = rowsum(dO o out), float32
        views = [t[None] for t in (q, k, v, g, lse, d_row)]
        args = (ctx.scale, ctx.slope, None, ctx.compute)
        if ctx.needs_input_grad[0]:
            dq = attention_dq_op(*views, plan_dq, geom_dq, *args)[0]
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = (t[0] for t in attention_dkv_op(*views, plan_dkv, geom_dkv, *args))
    grads = [t if t is None else t.to(x.dtype) for t, x in ((dq, q), (dk, k), (dv, v))]
    return (*grads, [None] * n, None, [None] * len(plan_dq), None, [None] * len(plan_dkv), None,
            None, None, None)


spmm_attention_op = _register(
    "spmm_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor[] plan, int[] geom, Tensor[] plan_dq, int[] geom_dq, "
    "Tensor[] plan_dkv, int[] geom_dkv, float scale, float slope, "
    "ScalarType compute_dtype=float) -> (Tensor, Tensor)",
    _attention_body, _attention_fake, _attn_flops, _attention_backward, _attention_setup)


def _k10_body(q, k, v, out, lse, g, plan, geom, scale, slope, summed,
              compute_dtype=torch.float32):
    p = _plan_of(plan, geom)
    sources = _sources_of(plan)
    if q.device.type == "cpu":
        return tuple(t.contiguous() for t in attention.bwd_plain(
            p, sources, q, k, v, out, lse, g, scale, slope, summed, compute_dtype))
    return attention._bwd_kernel(p, _walk_of(plan, geom), sources, q, k, v, out, lse, g, scale,
                                 slope, summed, compute_bwd(compute_dtype))


def _k10_fake(q, k, v, out, lse, g, plan, geom, scale, slope, summed, *args):
    rows = k.shape[0] if summed else geom[_G["total_blocks"]] * geom[_G["block_w"]]
    return (_f32(q.shape[0], q.shape[1], like=q), _f32(rows, q.shape[1], like=q),
            _f32(rows, v.shape[1], like=q))


attention_bwd_op = _register(
    "attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor g, Tensor[] plan, "
    "int[] geom, float scale, float slope, bool summed, ScalarType compute_dtype=float) -> "
    "(Tensor, Tensor, Tensor)",
    _k10_body, _k10_fake, _k10_flops)

BWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor g, Tensor lse, Tensor d_row, "
              "Tensor[] plan, int[] geom, float scale, float slope, ScalarType? plane_dtype, "
              "ScalarType compute_dtype=float)")


def _define_dq(name: str):
    """K14's op ("attention_mh_dq"), or K11's ("attention_dq": K14's kernel
    at one head, its own work list and count): dq (H, nq, dk) float32
    over (H, n, d) stacks."""
    entry = _ENTRY[name]

    def body(q, k, v, g, lse, d_row, plan, geom, scale, slope, plane_dtype,
             compute_dtype=torch.float32):
        p = _plan_of(plan, geom)
        if q.device.type == "cpu":
            if name == "attention_dq":
                return attention.attention_dq_reference(
                    p, *(t[0] for t in (q, k, v, g, lse, d_row)), scale=scale,
                    negative_slope=slope, compute_dtype=compute_dtype)[None]
            return attention_mh.attention_mh_dq_reference(
                p, q, k, v, g, lse, d_row, scale=scale, negative_slope=slope,
                plane_dtype=plane_dtype, compute_dtype=compute_dtype)
        return _dq_kernel(entry, p, _walk_of(plan, geom), q, k, v, g, lse, d_row, scale, slope,
                          plane_dtype, compute_bwd(compute_dtype))

    def fake(q, k, v, g, lse, d_row, plan, geom, *args):
        return _f32(*q.shape, like=q)

    return _register(name, BWD_SCHEMA + " -> Tensor", body, fake, _bwd_flops)


def _define_dkv(name: str):
    """K15's op ("attention_mh_dkv"), or K12's ("attention_dkv"): (dk, dv)
    (H, nk, d) float32 over the transpose plan."""
    entry = _ENTRY[name]

    def body(q, k, v, g, lse, d_row, plan, geom, scale, slope, plane_dtype,
             compute_dtype=torch.float32):
        p = _plan_of(plan, geom)
        if q.device.type == "cpu":
            if name == "attention_dkv":
                dk, dv = attention.attention_dkv_reference(
                    p, *(t[0] for t in (q, k, v, g, lse, d_row)), scale=scale,
                    negative_slope=slope, compute_dtype=compute_dtype)
                return dk[None], dv[None]
            return attention_mh.attention_mh_dkv_reference(
                p, q, k, v, g, lse, d_row, scale=scale, negative_slope=slope,
                plane_dtype=plane_dtype, compute_dtype=compute_dtype)
        return _dkv_kernel(entry, p, _walk_of(plan, geom), q, k, v, g, lse, d_row, scale, slope,
                           plane_dtype, compute_bwd(compute_dtype))

    def fake(q, k, v, g, lse, d_row, plan, geom, *args):
        return _f32(*k.shape, like=q), _f32(*v.shape, like=q)

    return _register(name, BWD_SCHEMA + " -> (Tensor, Tensor)", body, fake, _bwd_flops)


attention_dq_op = _define_dq("attention_dq")
attention_dkv_op = _define_dkv("attention_dkv")
attention_mh_dq_op = _define_dq("attention_mh_dq")
attention_mh_dkv_op = _define_dkv("attention_mh_dkv")


def _attention_mh_body(q, k, v, plan, geom, plan_dq, geom_dq, plan_dkv, geom_dkv, scale, slope,
                       plane_dtype, compute_dtype=torch.float32):
    p = _plan_of(plan, geom)
    half = compute_half(compute_dtype)
    if q.device.type == "cpu":
        out, lse = attention_mh.spmm_attention_mh_reference(
            p, q, k, v, scale=scale, negative_slope=slope, plane_dtype=plane_dtype,
            return_stats=True, out_dtype=torch.float32, compute_dtype=compute_dtype)
        return out.contiguous(), lse.contiguous()
    walk = _walk_of(plan, geom)
    if half is not None:
        return fwd_half_kernel(attention_mh.spmm_attention_mh, p, walk, q, k, v, scale, slope,
                               plane_dtype, *attention_mh.mh_geometry(*q.shape[::2]), half)
    return attention_mh._fwd_kernel(p, walk, q, k, v, scale, slope, plane_dtype)


def _attention_mh_fake(q, k, v, plan, geom, *args):
    padded = geom[_G["num_windows"]] * geom[_G["block_h"]]
    return (_f32(q.shape[0], q.shape[1], v.shape[2], like=q),
            _f32(q.shape[0], padded, like=q))


def _attention_mh_setup(ctx, inputs, output):
    q, k, v, plan, geom, plan_dq, geom_dq, plan_dkv, geom_dkv, scale, slope, pdt, *flag = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.geoms, ctx.scale, ctx.slope, ctx.pdt = (geom_dq, geom_dkv), scale, slope, pdt
    ctx.compute = flag[0] if flag else torch.float32
    ctx.sizes = (len(plan), len(plan_dq))
    ctx.save_for_backward(q, k, v, out, lse, *plan_dq, *plan_dkv)


def _attention_mh_backward(ctx, g, _g_lse):
    """K13's gradient: K14 over plan for dq, K15 over plan_t for dk and
    dv, with k and v rounded to the plane's type once for both, at the
    forward's compute_dtype. lse carries none."""
    geom_dq, geom_dkv = ctx.geoms
    q, k, v, out, lse, *rest = ctx.saved_tensors
    n, n_dq = ctx.sizes
    plan_dq, plan_dkv = rest[:n_dq], rest[n_dq:]
    if _absent(geom_dq) or _absent(geom_dkv):
        raise RuntimeError(f"{NAMESPACE}::spmm_attention_mh was called without its gradient's "
                           "operands: differentiate through spmm_attention_mh_ad")
    g = g.float().contiguous()
    d_row = (g * out.float()).sum(-1)  # D = rowsum(dO o out), float32
    args = (ctx.scale, ctx.slope, ctx.pdt, ctx.compute)
    # k and v in the plane's type once, for both kernels (a no-op for
    # float32 planes; the plain versions round them the same way)
    kp, vp = (t if ctx.pdt is None else t.to(ctx.pdt) for t in (k, v))
    dq = dk = dv = None
    if ctx.needs_input_grad[0]:
        dq = attention_mh_dq_op(q, kp, vp, g, lse, d_row, plan_dq, geom_dq, *args).to(q.dtype)
    if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
        dk, dv = attention_mh_dkv_op(q, kp, vp, g, lse, d_row, plan_dkv, geom_dkv, *args)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return (dq, dk, dv, [None] * n, None, [None] * len(plan_dq), None, [None] * len(plan_dkv),
            None, None, None, None, None)


spmm_attention_mh_op = _register(
    "spmm_attention_mh",
    "(Tensor q, Tensor k, Tensor v, Tensor[] plan, int[] geom, Tensor[] plan_dq, int[] geom_dq, "
    "Tensor[] plan_dkv, int[] geom_dkv, float scale, float slope, ScalarType? plane_dtype, "
    "ScalarType compute_dtype=float) -> (Tensor, Tensor)",
    _attention_mh_body, _attention_mh_fake, _attn_flops, _attention_mh_backward,
    _attention_mh_setup)


def call_attention(plan: SpmmPlan, q: Tensor, k: Tensor, v: Tensor, scale: float, slope: float,
              plan_t: SpmmPlan | None = None, differentiable: bool = False,
              compute_dtype=torch.float32):
    """K9's op (arguments checked by the caller): (out (num_nodes, dv), lse
    (padded_nodes,)) float32. `differentiable` and autograd taking the
    gradient: K11's and K12's operands with plan_t, K10's without (at
    compute_dtype too)."""
    dev = q.device
    ops, geom = operands(plan, "spmm_attention", dev)
    ops_dq, geom_dq = ops_dkv, geom_dkv = no_plan(ops, geom)
    if differentiable and _needs(q, k, v):
        if plan_t is None:
            ops_dq, geom_dq = operands(plan, "attention_bwd", dev)
        else:
            ops_dq, geom_dq = operands(plan, "attention_dq", dev)
            ops_dkv, geom_dkv = operands(plan_t, "attention_dkv", dev)
    return spmm_attention_op(q, k, v, ops, geom, ops_dq, geom_dq, ops_dkv, geom_dkv, scale, slope,
                             compute_dtype)


def call_attention_mh(plan: SpmmPlan, q: Tensor, k: Tensor, v: Tensor, scale: float, slope: float,
                 plane_dtype, plan_t: SpmmPlan | None = None, compute_dtype=torch.float32):
    """K13's op (arguments checked by the caller): (out (H, num_nodes,
    dv), lse (H, padded_nodes)) float32; with plan_t, K14's and K15's
    operands where autograd takes the gradient (at compute_dtype too)."""
    dev = q.device
    ops, geom = operands(plan, "spmm_attention_mh", dev)
    ops_dq, geom_dq = ops_dkv, geom_dkv = no_plan(ops, geom)
    if plan_t is not None and _needs(q, k, v):
        ops_dq, geom_dq = operands(plan, "attention_mh_dq", dev)
        ops_dkv, geom_dkv = operands(plan_t, "attention_mh_dkv", dev)
    return spmm_attention_mh_op(q, k, v, ops, geom, ops_dq, geom_dq, ops_dkv, geom_dkv, scale,
                                slope, plane_dtype, compute_dtype)


def call_attention_dq(name: str, plan: SpmmPlan, q, k, v, g, lse, d_row, scale: float,
                      slope: float, plane_dtype, compute_dtype=torch.float32):
    """K14's op (name "attention_mh_dq") or K11's ("attention_dq") on (H, n,
    d) stacks q, k, v, dO and (H, n) lse and D: dq float32."""
    ops, geom = operands(plan, name, q.device)
    op = attention_dq_op if name == "attention_dq" else attention_mh_dq_op
    return op(q, k, v, g, lse, d_row, ops, geom, scale, slope, plane_dtype, compute_dtype)


def call_attention_dkv(name: str, plan_t: SpmmPlan, q, k, v, g, lse, d_row, scale: float,
                       slope: float, plane_dtype, compute_dtype=torch.float32):
    """K15's op (name "attention_mh_dkv") or K12's ("attention_dkv") over the
    transpose plan: (dk, dv) float32."""
    ops, geom = operands(plan_t, name, q.device)
    op = attention_dkv_op if name == "attention_dkv" else attention_mh_dkv_op
    return op(q, k, v, g, lse, d_row, ops, geom, scale, slope, plane_dtype, compute_dtype)


def call_attention_bwd(plan: SpmmPlan, q, k, v, out, lse, g, scale: float, slope: float,
                       summed: bool, compute_dtype=torch.float32):
    """K10's op: (dq, dk, dv) summed into source rows, or (dq, dk_lane,
    dv_lane), float32."""
    ops, geom = operands(plan, "attention_bwd", q.device)
    return attention_bwd_op(q, k, v, out, lse, g, ops, geom, scale, slope, summed,
                            compute_dtype)


# --- K6 and K7: the ELL SpMM and SDDMM --------------------------------------------------

def _rows_of(tensors: list[Tensor], geom: list[int]):
    src, lane, items, merges = tensors[3:7]
    return ell.EllRows(src=src, lane=lane, items=items, merges=merges, slots=geom[_G["slots"]],
                       piece_lanes=ell.PIECE_LANES)


def _ell_body(feat, vals, plan, geom, plan_dv, geom_dv, vals_t, plan_t, geom_t, round_vals):
    if feat.device.type == "cpu":
        if round_vals:  # to the 16-bit type the features were rounded to
            vals = vals.to(feat.dtype).float()
        return ell.spmm_ell_reference(_ell_of(plan, geom, vals), feat, torch.float32)
    return ell.k6_kernel(_ell_of(plan, geom, vals), _rows_of(plan, geom), feat, round_vals)


def _ell_fake(feat, vals, plan, geom, *args):
    return _f32(geom[_G["num_nodes"]], feat.shape[1], like=feat)


def _ell_setup(ctx, inputs, output):
    feat, vals, plan, geom, plan_dv, geom_dv, vals_t, plan_t, geom_t, round_vals = inputs
    ctx.geoms, ctx.dtype, ctx.has_t = (geom_dv, geom_t), feat.dtype, vals_t is not None
    ctx.sizes = (len(plan), len(plan_dv))
    ctx.save_for_backward(feat, *([vals_t] if ctx.has_t else []), *plan_dv, *plan_t)


def _ell_backward(ctx, grad):
    """K6's gradient: feat's, K6 over plan_t's lanes; vals', K7 over plan."""
    geom_dv, geom_t = ctx.geoms
    saved = list(ctx.saved_tensors)
    feat, vals_t = saved[0], saved[1] if ctx.has_t else None
    rest = saved[1 + ctx.has_t:]
    n, n_dv = ctx.sizes
    plan_dv, plan_t = rest[:n_dv], rest[n_dv:]
    g = grad.float().contiguous()
    dfeat = dvals = None
    if ctx.needs_input_grad[0]:
        if vals_t is None or _absent(geom_t):
            raise ValueError(ell.NEEDS_LANES_T)
        dfeat = spmm_ell_op(g, vals_t, plan_t, geom_t, *no_plan(plan_t, geom_t), None,
                            *no_plan(plan_t, geom_t), False).to(ctx.dtype)
    if ctx.needs_input_grad[1]:
        if _absent(geom_dv):
            raise RuntimeError(f"{NAMESPACE}::spmm_ell was called without K7's operands: "
                               "differentiate through spmm_ell_ad")
        dvals = spmm_ell_dvals_op(feat.float().contiguous(), g, plan_dv, geom_dv,
                                  *no_plan(plan_dv, geom_dv), *no_plan(plan_dv, geom_dv))
    return (dfeat, dvals, [None] * n, None, [None] * n_dv, None, None, [None] * len(plan_t),
            None, None)


spmm_ell_op = _register(
    "spmm_ell",
    "(Tensor feat, Tensor vals, Tensor[] plan, int[] geom, Tensor[] plan_dv, int[] geom_dv, "
    "Tensor? vals_t, Tensor[] plan_t, int[] geom_t, bool round_vals) -> Tensor",
    _ell_body, _ell_fake, _nnz_flops, _ell_backward, _ell_setup)


def _ell_dvals_body(feat, g, plan, geom, plan_x, geom_x, plan_t, geom_t):
    p = _ell_of(plan, geom)
    if feat.device.type == "cpu":
        return ell.spmm_ell_dvals_reference(p, feat, g)
    sources = None
    if len(plan) > 3:
        pieces, lane, src, row = plan[3:7]
        sources = ell.EllSources(lane=lane, src=src, row=row, pieces=pieces,
                                 piece_lanes=ell.DVALS_PIECE_LANES)
    return ell.k7_kernel(p, sources, feat, g)


def _ell_dvals_fake(feat, g, plan, geom, *args):
    return _f32(geom[_G["total_blocks"]], geom[_G["block_w"]], like=feat)


def _ell_dvals_setup(ctx, inputs, output):
    feat, g, plan, geom, plan_x, geom_x, plan_t, geom_t = inputs
    ctx.geoms, ctx.dtypes = (geom_x, geom_t), (feat.dtype, g.dtype)
    ctx.sizes = (len(plan), len(plan_x))
    ctx.save_for_backward(feat, g, *plan_x, *plan_t)


def _ell_dvals_backward(ctx, grad):
    """The SDDMM's gradient, with feat = y (source rows) and g = x
    (destination rows): dx = (A o G) @ y, K6 over plan; dy = (A o G)^T @ x,
    K6 over plan_t, whose lanes take G through the lane map (the last of
    plan_t's operands, `ell.ell_lane_map`)."""
    geom_x, geom_t = ctx.geoms
    y, x, *rest = ctx.saved_tensors
    n, n_x = ctx.sizes
    plan_x, plan_t = rest[:n_x], rest[n_x:]
    if _absent(geom_x) or _absent(geom_t):
        raise RuntimeError(f"{NAMESPACE}::spmm_ell_dvals was called without its gradient's "
                           "operands: differentiate through sddmm_ell_ad")
    lanes = grad.float().contiguous()
    dy = dx = None
    if ctx.needs_input_grad[1]:
        dx = spmm_ell_op(y.float().contiguous(), lanes, plan_x, geom_x, *no_plan(plan_x, geom_x),
                         None, *no_plan(plan_x, geom_x), False).to(ctx.dtypes[1])
    if ctx.needs_input_grad[0]:
        lane_map = plan_t[-1]
        lanes_t = lanes.reshape(-1).index_select(0, lane_map.clamp(min=0))
        lanes_t = lanes_t.masked_fill_(lane_map < 0, 0).view(-1, geom_t[_G["block_w"]])
        ops_t = plan_t[:-1]
        dy = spmm_ell_op(x.float().contiguous(), lanes_t, ops_t, geom_t, *no_plan(ops_t, geom_t),
                         None, *no_plan(ops_t, geom_t), False).to(ctx.dtypes[0])
    return dy, dx, [None] * n, None, [None] * n_x, None, [None] * len(plan_t), None


spmm_ell_dvals_op = _register(
    "spmm_ell_dvals",
    "(Tensor feat, Tensor g, Tensor[] plan, int[] geom, Tensor[] plan_x, int[] geom_x, "
    "Tensor[] plan_t, int[] geom_t) -> Tensor",
    _ell_dvals_body, _ell_dvals_fake, _nnz_flops, _ell_dvals_backward, _ell_dvals_setup)


def call_ell(plan: EllPlan, feat: Tensor, plan_t: EllPlan | None = None,
        round_vals: bool = False) -> Tensor:
    """K6's op on `plan` (its lane values) and `feat` (checked by the
    caller), with K7's operands where autograd takes the values' gradient
    and plan_t's (its lane values) where it takes feat's; float32
    (num_nodes, D)."""
    dev = feat.device
    ops, geom = ell_operands(plan, "spmm_ell", dev)
    wide = ell.k7_wide_rows(plan, feat.shape[1])
    ops_dv, geom_dv = (ell_operands(plan, "spmm_ell_dvals", dev, wide) if _needs(plan.vals)
                       else no_plan(ops, geom))
    vals_t, (ops_t, geom_t) = None, no_plan(ops, geom)
    if plan_t is not None and plan_t.vals is not None and _needs(feat):
        vals_t, (ops_t, geom_t) = plan_t.vals, ell_operands(plan_t, "spmm_ell", dev)
    return spmm_ell_op(feat, plan.vals, ops, geom, ops_dv, geom_dv, vals_t, ops_t, geom_t,
                       round_vals)


def call_ell_dvals(plan: EllPlan, feat: Tensor, g: Tensor, plan_t: EllPlan | None = None) -> Tensor:
    """K7's op on the ELL plan (arguments checked by the caller): the
    (total_blocks, block_w) lane plane; with plan_t, the SDDMM's gradient
    operands (K6's over plan, and over plan_t with the lane map) where
    autograd takes it."""
    dev = feat.device
    ops, geom = ell_operands(plan, "spmm_ell_dvals", dev, ell.k7_wide_rows(plan, feat.shape[1]))
    ops_x, geom_x = ops_t, geom_t = no_plan(ops, geom)
    if plan_t is not None and _needs(feat, g):
        ops_x, geom_x = ell_operands(plan, "spmm_ell", dev)
        ops_t, geom_t = ell_operands(plan_t, "spmm_ell", dev)
        ops_t = [*ops_t, ell.ell_lane_map(plan, plan_t)]
    return spmm_ell_dvals_op(feat, g, ops, geom, ops_x, geom_x, ops_t, geom_t)


def loaders_of(fn) -> list:
    """The kernel libraries of the ops in `fn`'s graph, where it has one (a
    loaded servable, a GraphModule): those it can launch. A plain callable
    gets none: the kernels its first call launches build there."""
    graph = getattr(fn, "graph", None)
    nodes = [] if graph is None else [
        node for node in graph.nodes
        if node.op == "call_function" and str(node.target).startswith(NAMESPACE + ".")]
    names = {str(node.target).split(".")[1] for node in nodes}
    loaders = [f for name in sorted(names) for f in LOADERS[name]]
    loaders += [fwd_half_library(dt) for dt in map(_compute_dtype_of, nodes)
                if dt in HALF_DTYPES]
    return list(dict.fromkeys(loaders))


def _compute_dtype_of(node):
    """The compute_dtype of a K9 or K13 node of a program (float32 for
    the other ops and where the call leaves the default)."""
    place = {"spmm_attention": 11, "spmm_attention_mh": 12}.get(str(node.target).split(".")[1])
    if place is None:
        return torch.float32
    if "compute_dtype" in node.kwargs:
        return node.kwargs["compute_dtype"]
    return node.args[place] if len(node.args) > place else torch.float32

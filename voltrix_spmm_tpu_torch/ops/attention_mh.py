"""Multi-head fused graph attention on the binned plan: kernels K13, K14
and K15, their wrappers, plain versions and gradient (counterpart of
voltrix_spmm_tpu/ops/attention_mh.py).

For head h, destination row r and its in-neighbours l (the plan's set
bits; duplicate CSR edges collapse):

    raw = q[h, r] . k[h, l],  s = act(scale * raw)  (leaky_relu, slope 1 = identity)
    out[h, r] = sum_l exp(s - m_r) v[h, l] / max(l_r, 1e-30),  lse[h, r] = m_r + log(l_r)

A row with no edges, and every row of an empty window, gets out 0 and
lse exactly 1e30.

- `spmm_attention_mh(plan, q, k, v)` runs K13 (csrc/attn_fwd.cu, beside
  K9, replacing attention_mh.py:_attn_fwd_mh_kernel): K9's row walk over
  K13's work list (`ops/attention.py:attention_walk`), a group of
  HEAD_GROUP heads sharing each walk of the bitmask, the pieces' (m, l,
  acc) shares of a cut group merged per head in piece order.
- `attention_mh_dq` runs K14 (csrc/attn_mh_dq.cu, replacing
  _attn_bwd_dq_mh_kernel): dq[h, r] = sum_l ds k[h, l] over `plan`, with
  p = exp(s - lse_r), ds = p (dO_r . v_l - D_r) act'(raw) scale and
  D_r = dO_r . out_r; the same row walk on its own work list, a lane per
  row of dq for a group of heads, cut groups merged in piece order.
- `attention_mh_dkv` runs K15 (csrc/attn_mh_dkv.cu, replacing
  _attn_bwd_dkv_mh_kernel) over the transpose plan: dk[h, l] = sum_r ds
  q[h, r] and dv[h, l] = sum_r p dO[h, r]; the row walk over the
  transpose plan's own work list (`plan_walk(plan_t,
  "attention_mh_dkv")`, kept apart from K13's and K14's even where
  plan_t is plan), a lane per row of dk and dv.
- `spmm_attention_mh_ad` is K13's op with its gradient over the three.

K14's and K15's launches, the plain versions' arithmetic and the
argument checks live in ops/_attn_core.py, which the single-head op
(ops/attention.py) shares: its kernels K11 and K12 are K14 and K15 at H =
1. This module adds K13's launch, the head stacks' entry points, the
plane dtype, the subtile flag and its own counts.

plane_dtype=torch.bfloat16 rounds exactly the operands the JAX package
streams in bf16: k and v everywhere, q and dO where K15 gathers them.
K13's q and K14's q and dO stay float32; all sums are float32. The
backward casts k and v to the plane's type once for K14 and K15.

subtile=True is accepted, as in JAX, for plans with block_h % 128 == 0.
The JAX kernels' subtile branch skips a block's empty 128-row sub-windows;
the port's kernels visit only set bits, so they skip them by
construction, and the result is the same.

K13-K15 are the registered ops ``torch.ops.voltrix.spmm_attention_mh``,
``attention_mh_dq`` and ``attention_mh_dkv`` (ops/library.py), which every
call goes through; K13's op carries `spmm_attention_mh_ad`'s gradient. An
op's body runs the plain versions on a CPU tensor
(`spmm_attention_mh_reference`, `attention_mh_dq_reference`,
`attention_mh_dkv_reference`), which take the edges from the bitmask,
compute scores by gather, the row maxima and denominators by segment
reductions, and aggregate with `index_add_`. On a CUDA tensor it launches
the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from ..format.plan import SpmmPlan
from ._attn_core import (  # noqa: F401 (load_*: the builds of this module's kernels)
    _EMPTY_LSE,
    BF16_BACKWARD,
    IMPLS,
    _check_bwd,
    _check_plan,
    _check_qkv,
    _dkv_plain,
    _dq_plain,
    _fwd_plain,
    _head_rows,
    _on_cuda,
    _plane,
    _refuse_knobs,
    _rows16,
    _strides,
    compute_bf16,
    group_and_chunk,
    load_dkv_library,
    load_dq_library,
    op_compute_dtype,
)
from .attention import load_mh_fwd_library
from .block_spmm import _INT_MAX, launch
from .reference import CHUNK_BYTES

# heads whose walk K13 shares (1, 2, 4 or 8): the fastest of
# python3 -m voltrix_spmm_tpu_torch.tools.attn_task_sweep --kernels
# spmm_attention_mh at path G's two layers
HEAD_GROUP = 4
# K13's column chunks (a lane's acc columns of each head) by head group:
# the template pairs of csrc/attn_fwd.cu:dispatch_mh, whose registers fit
# a lane
MH_ACC_WIDTHS = {1: (8, 16, 32, 40, 64), 2: (8, 16, 40), 4: (8, 16), 8: (8,)}


def mh_geometry(heads: int, dv: int) -> tuple[int, int]:
    """(head group, column chunk) of K13 for `heads` heads of width dv:
    `group_and_chunk` over MH_ACC_WIDTHS with HEAD_GROUP heads at most."""
    return group_and_chunk(heads, dv, HEAD_GROUP, MH_ACC_WIDTHS)


def _fwd_kernel(plan: SpmmPlan, walk, q, k, v, scale: float, slope: float, pdt):
    """out (H, nq, dv) and lse (H, padded_nodes), float32, through K13, the
    op's body (ops/library.py): the walk over `walk`
    (`attention_walk(plan, "spmm_attention_mh")`) for each head group and,
    when a group of rows is cut, the merge of each head's shares. q, k and
    v are read through their head and row strides (`_head_rows`). Every
    row is written."""
    name = "spmm_attention_mh"
    heads, nq, dk = q.shape
    nk, dv = k.shape[1], v.shape[2]
    dev = q.device
    f32, tdt = torch.float32, pdt or torch.float32
    qc, kc, vc = (_head_rows(name, dev, t, dt) for t, dt in ((q, f32), (k, tdt), (v, tdt)))
    cfg = plan.config
    out = torch.empty(heads, nq, dv, dtype=f32, device=dev)
    lse = torch.empty(heads, plan.padded_nodes, dtype=f32, device=dev)
    if dv == 0 or plan.total_blocks == 0:
        return out.zero_(), lse.fill_(_EMPTY_LSE)
    hg, acc = mh_geometry(heads, dv)
    if walk.tasks.shape[0] * -(-heads // hg) > _INT_MAX or -(-dv // acc) > 65535:
        raise ValueError(f"{name}: more tasks, heads or columns than the grid takes")
    ws_ml = ws_acc = None
    if walk.slots:
        ws_ml = torch.empty(walk.slots * heads * walk.rows * 2, dtype=f32, device=dev)
        ws_acc = torch.empty(walk.slots * heads * walk.rows * dv, dtype=f32, device=dev)
    launch(
        name, load_mh_fwd_library(), q, plan.bitmask.data_ptr(), plan.hind.data_ptr(),
        walk.tasks.data_ptr(), walk.merges.data_ptr(), qc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), out.data_ptr(), lse.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(), None if ws_acc is None else ws_acc.data_ptr(),
        walk.tasks.shape[0], walk.merges.shape[0], heads, hg, cfg.words_per_col, cfg.block_h,
        cfg.block_w, nq, nk, dk, dv, plan.padded_nodes, acc, int(pdt is not None),
        float(scale), float(slope), _rows16(qc), _rows16(kc), _rows16(vc),
        *_strides(qc, kc, vc),
    )
    spmm_attention_mh.launches += 1
    return out, lse


def _check_subtile(subtile: bool, *plans: SpmmPlan) -> None:
    """The JAX package asserts block_h % 128 == 0 for subtile=True
    (attention_mh.py:307-308, :654-655, :776-777)."""
    if subtile and any(p.config.block_h % 128 for p in plans):
        raise ValueError("subtile=True skips 128-row sub-windows: it needs block_h % 128 == 0, "
                         f"got {[p.config.block_h for p in plans]}")


# --- the plain versions ----------------------------------------------------

def spmm_attention_mh_reference(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                                negative_slope: float = 1.0, plane_dtype=None,
                                return_stats: bool = False, out_dtype=None, compute_dtype=None,
                                chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K13: out (H, num_nodes, dv) and, with
    return_stats, lse (H, padded_nodes); scores by gather over the plan's
    edges, row maxima by `scatter_reduce("amax")`, denominators and the
    aggregation by `index_add_`, in chunks of about `chunk_bytes`;
    compute_dtype=torch.bfloat16 rounds at the JAX package's points
    (ops/_attn_core.py:_fwd_plain_bf16)."""
    spmm_attention_mh_reference.calls += 1
    compute = compute_bf16(compute_dtype)
    dk = _check_qkv(plan, q, k, v, "spmm_attention_mh_reference")[3]
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out, lse = _fwd_plain(plan, q, k, v, scale, negative_slope, _plane(plane_dtype), chunk_bytes,
                          compute)
    out = out.to(v.dtype if out_dtype is None else out_dtype)
    return (out, lse) if return_stats else out


spmm_attention_mh_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def attention_mh_dq_reference(plan: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                              negative_slope: float = 1.0, plane_dtype=None,
                              chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K14: dq (H, num_nodes, dk) float32 over `plan`,
    from the forward's lse and D = rowsum(dO o out)."""
    attention_mh_dq_reference.calls += 1
    _check_bwd(plan, q, k, v, g, lse, d_row, "attention_mh_dq_reference", False)
    return _dq_plain(plan, q, k, v, g, lse, d_row, scale, negative_slope, _plane(plane_dtype),
                     chunk_bytes)


attention_mh_dq_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def attention_mh_dkv_reference(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                               negative_slope: float = 1.0, plane_dtype=None,
                               chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K15: (dk, dv) float32 over the transpose plan,
    whose rows are the source rows of k and v and whose lanes are the
    destination rows of q, dO, lse and D."""
    attention_mh_dkv_reference.calls += 1
    _check_bwd(plan_t, q, k, v, g, lse, d_row, "attention_mh_dkv_reference", True)
    return _dkv_plain(plan_t, q, k, v, g, lse, d_row, scale, negative_slope,
                      _plane(plane_dtype), chunk_bytes)


attention_mh_dkv_reference.calls = 0  # plain-int call count, read by chip_smoke.py


# --- the kernels -------------------------------------------------------------

def spmm_attention_mh(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                      negative_slope: float = 1.0, compute_dtype=None, precision=None,
                      plane_dtype=None, return_stats: bool = False, subtile: bool = False,
                      out_dtype=None):
    """All-head fused attention aggregation through kernel K13, as the
    registered op ``torch.ops.voltrix.spmm_attention_mh`` (ops/library.py):
    per head h, out[h, r] = softmax over r's in-neighbours l of act(scale
    q[h, r] . k[h, l]), applied to v[h]. q (H, num_nodes, dk), k (H,
    source_rows, dk), v (H, source_rows, dv); returns (H, num_nodes, dv) in
    `out_dtype` (default v's) and, with return_stats, lse (H, padded_nodes)
    float32. scale defaults to 1/sqrt(dk); negative_slope 1.0 is the
    identity. plane_dtype=torch.bfloat16 rounds k and v to bf16.
    compute_dtype=torch.bfloat16 rounds q, k, v and p to bf16 before their
    products, as the JAX package does (csrc/attn_fwd_bf16.cu; counted in
    `launches` and `launches_bf16`); its inputs may not need a gradient
    (NotImplementedError). A plan with a value plane is refused
    (ValueError), as the single-head op refuses it."""
    from . import library

    _refuse_knobs(compute_dtype, precision)
    heads, nq, _, dk, dv = _check_qkv(plan, q, k, v, "spmm_attention_mh")
    _check_subtile(subtile, plan)
    _on_cuda(q, "spmm_attention_mh")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out_dtype = v.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        out = torch.zeros(heads, nq, dv, dtype=out_dtype, device=q.device)
        if return_stats:
            return out, torch.full((heads, plan.padded_nodes), _EMPTY_LSE,
                                   dtype=torch.float32, device=q.device)
        return out
    out, lse = library.call_attention_mh(plan, q, k, v, float(scale), float(negative_slope),
                                         _plane(plane_dtype),
                                         compute_dtype=op_compute_dtype(compute_dtype))
    out = out.to(out_dtype)
    return (out, lse) if return_stats else out


spmm_attention_mh.launches = 0  # plain-int launch count, read by chip_smoke.py
# of which at compute_dtype=bfloat16 (csrc/attn_fwd_bf16.cu)
spmm_attention_mh.launches_bf16 = 0


def attention_mh_dq(plan: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                    negative_slope: float = 1.0, plane_dtype=None) -> torch.Tensor:
    """dq (H, num_nodes, dk) float32 through kernel K14 over `plan` (see
    the plain version), as the registered op
    ``torch.ops.voltrix.attention_mh_dq`` (ops/library.py)."""
    from . import library

    _on_cuda(q, "attention_mh_dq")
    _check_bwd(plan, q, k, v, g, lse, d_row, "attention_mh_dq", False)
    return library.call_attention_dq("attention_mh_dq", plan, q, k, v, g, lse, d_row, float(scale),
                                float(negative_slope), _plane(plane_dtype))


attention_mh_dq.launches = 0  # plain-int launch count, read by chip_smoke.py


def attention_mh_dkv(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                     negative_slope: float = 1.0, plane_dtype=None):
    """(dk, dv) float32 through kernel K15 over the transpose plan (see
    the plain version), as the registered op
    ``torch.ops.voltrix.attention_mh_dkv`` (ops/library.py)."""
    from . import library

    _on_cuda(q, "attention_mh_dkv")
    _check_bwd(plan_t, q, k, v, g, lse, d_row, "attention_mh_dkv", True)
    return library.call_attention_dkv("attention_mh_dkv", plan_t, q, k, v, g, lse, d_row,
                                 float(scale), float(negative_slope), _plane(plane_dtype))


attention_mh_dkv.launches = 0  # plain-int launch count, read by chip_smoke.py


# --- the gradient --------------------------------------------------------------

class _PlainAttentionMH(torch.autograd.Function):
    """`spmm_attention_mh_ad(impl="reference")`: the plain versions of K13,
    K14 and K15 with the kernels' gradient."""

    @staticmethod
    def forward(ctx, q, k, v, plan, plan_t, scale, slope, pdt):
        ctx.plan, ctx.plan_t, ctx.scale, ctx.slope, ctx.pdt = plan, plan_t, scale, slope, pdt
        out, lse = spmm_attention_mh_reference(plan, q, k, v, scale=scale, negative_slope=slope,
                                               plane_dtype=pdt, return_stats=True)
        # residuals are O(n): the inputs, out and lse; no per-edge tensor
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.float().contiguous()
        d_row = (g * out.float()).sum(-1)  # D = rowsum(dO o out), float32
        kw = dict(scale=ctx.scale, negative_slope=ctx.slope, plane_dtype=ctx.pdt)
        # k and v in the plane's type once, as the op's gradient does
        kp, vp = (t if ctx.pdt is None else t.to(ctx.pdt) for t in (k, v))
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = attention_mh_dq_reference(ctx.plan, q, kp, vp, g, lse, d_row, **kw).to(q.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = attention_mh_dkv_reference(ctx.plan_t, q, kp, vp, g, lse, d_row, **kw)
            dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        return dq, dk, dv, None, None, None, None, None


def spmm_attention_mh_ad(plan: SpmmPlan, q, k, v, *, plan_t: SpmmPlan, scale: float | None = None,
                         negative_slope: float = 1.0, compute_dtype=None, precision=None,
                         plane_dtype=None, subtile: bool = False, impl: str = "auto"):
    """Differentiable all-head fused attention (gradients for the q, k
    and v stacks): the registered op ``torch.ops.voltrix.spmm_attention_mh``
    (ops/library.py) and its gradient. Forward K13 (saving out and lse,
    never a per-edge tensor); backward K14 over `plan` for dq and K15 over
    `plan_t` (csr_preprocess of A^T; the same object for a symmetric graph)
    for dk and dv. impl: "auto" (the kernels on the card, the plain
    versions on the CPU) or "reference" (the plain versions).
    compute_dtype=torch.bfloat16 runs the forward alone: inputs that need a
    gradient raise NotImplementedError before any launch (the backward's
    compute_dtype is ROADMAP.md item 9)."""
    from . import library

    if plan_t is None:
        raise ValueError(
            "spmm_attention_mh_ad requires plan_t (csr_preprocess of A^T): the backward "
            "runs dK/dV over the transpose plan"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: it takes {', '.join(IMPLS)}")
    _refuse_knobs(compute_dtype, precision)
    compute = op_compute_dtype(compute_dtype)
    dk = _check_qkv(plan, q, k, v, "spmm_attention_mh_ad")[3]
    _check_plan(plan_t, "spmm_attention_mh_ad")
    _check_subtile(subtile, plan, plan_t)
    _on_cuda(q, "spmm_attention_mh_ad")
    if (plan_t.num_nodes, plan_t.source_rows) != (plan.source_rows, plan.num_nodes):
        raise ValueError("plan_t must be the transpose of plan")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else float(scale)
    if compute == torch.bfloat16:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(BF16_BACKWARD)
        if impl == "reference":
            return spmm_attention_mh_reference(plan, q, k, v, scale=scale,
                                               negative_slope=negative_slope,
                                               plane_dtype=plane_dtype, compute_dtype=compute)
    if impl == "reference":
        return _PlainAttentionMH.apply(q, k, v, plan, plan_t, scale, float(negative_slope),
                                       _plane(plane_dtype))
    return library.call_attention_mh(plan, q, k, v, scale, float(negative_slope),
                                     _plane(plane_dtype), plan_t=plan_t, compute_dtype=compute)[0]

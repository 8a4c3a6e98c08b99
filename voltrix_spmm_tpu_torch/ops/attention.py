"""Fused graph attention on the binned plan, one head at a time: kernels
K9, K10, K11 and K12, their wrappers, plain versions and gradient
(counterpart of voltrix_spmm_tpu/ops/attention.py). The arithmetic and
the launches it shares with the multi-head op (ops/attention_mh.py) are
in ops/_attn_core.py.

For destination row r and its in-neighbours l (the plan's set bits;
duplicate CSR edges collapse):

    raw = q[r] . k[l],  s = act(scale * raw)  (leaky_relu, slope 1 = identity)
    out[r] = sum_l exp(s - m_r) v[l] / max(l_r, 1e-30),  lse[r] = m_r + log(l_r)

A row with no edges, and every row of an empty window, gets out 0 and
lse exactly 1e30. The backward, with p = exp(s - lse_r), D_r = dO_r .
out_r and ds = p (dO_r . v_l - D_r) act'(raw) scale:

    dq[r] = sum_l ds k[l],  dk[l] = sum_r ds q[r],  dv[l] = sum_r p dO[r]

- `spmm_attention` runs K9 (replacing attention.py:_attn_fwd_kernel),
  `attention_dq` K11 (_attn_bwd_dq_kernel: dq over `plan`) and
  `attention_dkv` K12 (_attn_bwd_dkv_kernel: dk, dv over the transpose
  plan). These are the kernels of K13, K14 and K15 (csrc/attn_mh_*.cu)
  launched with H = 1 and float32 planes: the JAX package keeps a
  single-head and a multi-head copy of each only because the TPU pays one
  gather call per head.
- `attention_bwd` runs K10 (csrc/attn_bwd.cu, replacing _attn_bwd_kernel):
  dq over the forward plan and the per-lane planes dk_lane and dv_lane,
  where lane (b, j) sums the set bits of column j of block b;
  `scatter_lanes` sums such a plane into source rows by `hind`.
- `spmm_attention_ad` is the autograd Function: forward K9; backward K11
  and K12 when given the transpose plan, else K10 and `scatter_lanes`.

A CPU tensor takes the plain versions, which take the edges from the
bitmask, compute scores by gather, the row maxima and denominators by
segment reductions, and aggregate with `index_add_`. A CUDA tensor
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..format.plan import SpmmPlan
from ._attn_core import (
    _BATCH,
    _EMPTY_LSE,
    _TASK_BLOCKS,
    IMPLS,
    _act,
    _check_bwd,
    _check_plan,
    _check_qkv,
    _dkv_kernel,
    _dkv_plain,
    _dq_kernel,
    _dq_plain,
    _ds,
    _edge_chunks,
    _edges,
    _fwd_kernel,
    _fwd_plain,
    _geometry,
    _loader,
    _on_cuda,
    _plan_args,
    _refuse_knobs,
    _tensors,
    _vec4,
)
from .block_spmm import launch
from .reference import CHUNK_BYTES

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# bitmask hind wob block_ptr, the kernel's tensors, then the geometry
load_bwd_library = _loader("attn_bwd", "voltrix_attn_bwd",
                           [_p] * 13 + [_i] * 10 + [_f, _f, _i, _i, _p])


def _one_head(name: str, *tensors):
    """One head's (n, d) matrices q, k, v and g and (n,) vectors lse and D,
    as H = 1 views."""
    if any(t.dim() != (1 if i >= 4 else 2) for i, t in enumerate(tensors)):
        raise ValueError(f"{name} takes one head: (n, d) matrices q, k, v and g, (n,) vectors "
                         "lse and D; spmm_attention_mh takes (H, n, d) stacks")
    return [t[None] for t in tensors]


# --- K9: the forward -------------------------------------------------------------

def _check_single(plan: SpmmPlan, q, k, v, name: str):
    """(nq, nk, dk, dv) of one head's q (num_nodes, dk), k (source_rows, dk)
    and v (source_rows, dv)."""
    return _check_qkv(plan, *_one_head(name, q, k, v), name)[1:]


def spmm_attention_reference(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                             negative_slope: float = 1.0, return_stats: bool = False,
                             out_dtype=None, chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K9: out (num_nodes, dv) in `out_dtype` (default
    v's) and, with return_stats, lse (padded_nodes,) float32."""
    spmm_attention_reference.calls += 1
    dk = _check_single(plan, q, k, v, "spmm_attention_reference")[2]
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out, lse = _fwd_plain(plan, q[None], k[None], v[None], scale, negative_slope, None,
                          chunk_bytes)
    out = out[0].to(v.dtype if out_dtype is None else out_dtype)
    return (out, lse[0]) if return_stats else out


spmm_attention_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def spmm_attention(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                   negative_slope: float = 1.0, block_d=None, compute_dtype=None,
                   precision=None, return_stats: bool = False, interpret=None, out_dtype=None):
    """Fused attention aggregation of one head through kernel K9 (K13's
    kernel at H = 1): out[r] = softmax over r's in-neighbours l of
    act(scale q[r] . k[l]), applied to v. q (num_nodes, dk), k (source_rows,
    dk), v (source_rows, dv); returns (num_nodes, dv) in `out_dtype`
    (default v's) and, with return_stats, lse (padded_nodes,) float32.
    scale defaults to 1/sqrt(dk); negative_slope 1.0 is the identity. A
    plan with a value plane raises ValueError; the TPU knobs block_d,
    precision, a non-float32 compute_dtype and interpret raise
    NotImplementedError."""
    _refuse_knobs(compute_dtype, precision, block_d, interpret)
    nq, _, dk, dv = _check_single(plan, q, k, v, "spmm_attention")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out_dtype = v.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        out = torch.zeros(nq, dv, dtype=out_dtype, device=q.device)
        if return_stats:
            return out, torch.full((plan.padded_nodes,), _EMPTY_LSE, dtype=torch.float32,
                                   device=q.device)
        return out
    if not _on_cuda(q, "spmm_attention"):
        return spmm_attention_reference(plan, q, k, v, scale=scale,
                                        negative_slope=negative_slope,
                                        return_stats=return_stats, out_dtype=out_dtype)
    out, lse = _fwd_kernel(spmm_attention, plan, q[None], k[None], v[None], scale,
                           negative_slope, None)
    out = out[0].to(out_dtype)
    return (out, lse[0]) if return_stats else out


spmm_attention.launches = 0  # plain-int launch count, read by chip_smoke.py


# --- K11 and K12: the split backward ----------------------------------------------

def attention_dq_reference(plan: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                           negative_slope: float = 1.0,
                           chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K11: dq (num_nodes, dk) float32 over `plan`,
    from the forward's lse and D = rowsum(dO o out)."""
    attention_dq_reference.calls += 1
    views = _one_head("attention_dq_reference", q, k, v, g, lse, d_row)
    _check_bwd(plan, *views, "attention_dq_reference", False)
    return _dq_plain(plan, *views, scale, negative_slope, None, chunk_bytes)[0]


attention_dq_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def attention_dkv_reference(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                            negative_slope: float = 1.0, chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K12: (dk, dv) float32 over the transpose plan."""
    attention_dkv_reference.calls += 1
    views = _one_head("attention_dkv_reference", q, k, v, g, lse, d_row)
    _check_bwd(plan_t, *views, "attention_dkv_reference", True)
    dk, dv = _dkv_plain(plan_t, *views, scale, negative_slope, None, chunk_bytes)
    return dk[0], dv[0]


attention_dkv_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def attention_dq(plan: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                 negative_slope: float = 1.0) -> torch.Tensor:
    """dq (num_nodes, dk) float32 through kernel K11 (K14's kernel at H =
    1) over `plan`; see the plain version."""
    if not _on_cuda(q, "attention_dq"):
        return attention_dq_reference(plan, q, k, v, g, lse, d_row, scale=scale,
                                      negative_slope=negative_slope)
    views = _one_head("attention_dq", q, k, v, g, lse, d_row)
    _check_bwd(plan, *views, "attention_dq", False)
    return _dq_kernel(attention_dq, plan, *views, scale, negative_slope, None)[0]


attention_dq.launches = 0  # plain-int launch count, read by chip_smoke.py


def attention_dkv(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                  negative_slope: float = 1.0):
    """(dk, dv) float32 through kernel K12 (K15's kernel at H = 1) over the
    transpose plan; see the plain version."""
    if not _on_cuda(q, "attention_dkv"):
        return attention_dkv_reference(plan_t, q, k, v, g, lse, d_row, scale=scale,
                                       negative_slope=negative_slope)
    views = _one_head("attention_dkv", q, k, v, g, lse, d_row)
    _check_bwd(plan_t, *views, "attention_dkv", True)
    dk, dv = _dkv_kernel(attention_dkv, plan_t, *views, scale, negative_slope, None)
    return dk[0], dv[0]


attention_dkv.launches = 0  # plain-int launch count, read by chip_smoke.py


# --- K10: the self-contained backward ----------------------------------------------

def _check_lanes(plan: SpmmPlan, q, k, v, out, lse, g, name: str):
    """(nq, nk, dk, dv) of K10's inputs, after checking their shapes."""
    if out.dim() != 2 or tuple(out.shape) != tuple(g.shape):
        raise ValueError(f"{name}: out {tuple(out.shape)} and g {tuple(g.shape)} must both "
                         "be (num_nodes, dv)")
    return _check_bwd(plan, *_one_head(name, q, k, v, g, lse), None, name, False)[1:]


def attention_bwd_reference(plan: SpmmPlan, q, k, v, out, lse, g, *, scale: float,
                            negative_slope: float = 1.0, chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K10: (dq, dk_lane, dv_lane) float32. dq
    (num_nodes, dk) sums over `plan`'s windows; dk_lane (total_blocks *
    block_w, dk) and dv_lane (total_blocks * block_w, dv) hold, for lane
    (b, j), sum_r ds q[r] and sum_r p dO[r] over the set bits r of column j
    of block b. Lanes without bits are exactly 0."""
    attention_bwd_reference.calls += 1
    nq, _, dk, dv = _check_lanes(plan, q, k, v, out, lse, g, "attention_bwd_reference")
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    lse = lse.float()
    d_row = (gf * out.float()).sum(-1)
    lanes = plan.total_blocks * plan.config.block_w
    dev = q.device
    dq = torch.zeros(nq, dk, dtype=torch.float32, device=dev)
    dk_lane = torch.zeros(lanes, dk, dtype=torch.float32, device=dev)
    dv_lane = torch.zeros(lanes, dv, dtype=torch.float32, device=dev)
    rows, cols, lane = _edges(plan, chunk_bytes)
    for e0, e1 in _edge_chunks(rows.numel(), 1, 4 * dk + 3 * dv, chunk_bytes):
        r, c, ln = rows[e0:e1], cols[e0:e1], lane[e0:e1]
        qc, kc, gc = qf.index_select(0, r), kf.index_select(0, c), gf.index_select(0, r)
        raw = (qc * kc).sum(-1)
        p = torch.exp(_act(raw, scale, negative_slope) - lse.index_select(0, r))
        dp = (gc * vf.index_select(0, c)).sum(-1)
        ds = _ds(p, dp, d_row.index_select(0, r), raw, scale, negative_slope)
        dq.index_add_(0, r, ds[:, None] * kc)
        dk_lane.index_add_(0, ln, ds[:, None] * qc)
        dv_lane.index_add_(0, ln, p[:, None] * gc)
    return dq, dk_lane, dv_lane


attention_bwd_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def attention_bwd(plan: SpmmPlan, q, k, v, out, lse, g, *, scale: float,
                  negative_slope: float = 1.0):
    """(dq, dk_lane, dv_lane) float32 through kernel K10 (csrc/attn_bwd.cu);
    see the plain version. D = rowsum(dO o out) is one PyTorch reduction
    before the launch."""
    if not _on_cuda(q, "attention_bwd"):
        return attention_bwd_reference(plan, q, k, v, out, lse, g, scale=scale,
                                       negative_slope=negative_slope)
    name = "attention_bwd"
    nq, nk, dk, dv = _check_lanes(plan, q, k, v, out, lse, g, name)
    dev = q.device
    plan_ptrs = _plan_args(plan, dev, name)
    f32 = torch.float32
    qc, kc, vc, gc, lc = _tensors(name, dev, (q, f32), (k, f32), (v, f32), (g, f32), (lse, f32))
    d_row = (gc * out.float()).sum(-1)
    cfg = plan.config
    lanes = plan.total_blocks * cfg.block_w
    dq = torch.zeros(nq, dk, dtype=f32, device=dev)
    dk_lane = torch.zeros(lanes, dk, dtype=f32, device=dev)
    dv_lane = torch.zeros(lanes, dv, dtype=f32, device=dev)
    if plan.total_blocks == 0 or dk + dv == 0:
        return dq, dk_lane, dv_lane
    bh = cfg.block_h
    # ds in row order, p, ds and the row in edge order, the row sort's
    # counts and offsets, the source row in row order
    _, dc = _geometry(bh, 1, dk + dv, lambda g: 2 * bh + 1 + 5 * _BATCH, name)
    if -(-(dk + dv) // dc) > 65535:
        raise ValueError(f"{name}: dk + dv exceed the grid's limits")
    launch(
        name, load_bwd_library(), q,
        *plan_ptrs, qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
        lc.data_ptr(), d_row.data_ptr(), dq.data_ptr(), dk_lane.data_ptr(), dv_lane.data_ptr(),
        plan.total_blocks, cfg.words_per_col, bh, cfg.block_w, nq, nk, dk, dv, dc,
        _TASK_BLOCKS[name], float(scale), float(negative_slope), _vec4(dk, qc, kc),
        _vec4(dv, gc, vc),
    )
    attention_bwd.launches += 1
    return dq, dk_lane, dv_lane


attention_bwd.launches = 0  # plain-int launch count, read by chip_smoke.py


def scatter_lanes(plan: SpmmPlan, lane_plane: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Sum a per-lane plane (total_blocks * block_w, d) into (num_rows, d)
    by the plan's `hind` (the JAX package's segment_sum): a source row
    that several windows gather gets each window's lane; a lane whose hind
    lies outside [0, num_rows) is dropped, as segment_sum drops it."""
    idx = plan.hind.reshape(-1).long()
    if lane_plane.dim() != 2 or lane_plane.shape[0] != idx.numel():
        raise ValueError(f"scatter_lanes: the plane must be ({idx.numel()}, d), got "
                         f"{tuple(lane_plane.shape)}")
    idx = torch.where((idx >= 0) & (idx < num_rows), idx, num_rows)  # row num_rows: dropped
    out = torch.zeros(num_rows + 1, lane_plane.shape[1], dtype=lane_plane.dtype,
                      device=lane_plane.device)
    return out.index_add_(0, idx, lane_plane)[:num_rows]


# --- the gradient ------------------------------------------------------------------

class _AttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, plan, plan_t, scale, slope, impl):
        ctx.plan, ctx.plan_t, ctx.scale, ctx.slope, ctx.impl = plan, plan_t, scale, slope, impl
        fwd = spmm_attention_reference if impl == "reference" else spmm_attention
        out, lse = fwd(plan, q, k, v, scale=scale, negative_slope=slope, return_stats=True)
        # residuals are O(n): the inputs, out and lse; no per-edge tensor
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.float().contiguous()
        kw = dict(scale=ctx.scale, negative_slope=ctx.slope)
        ref = ctx.impl == "reference"
        dq = dk = dv = None
        if ctx.plan_t is None:
            bwd = attention_bwd_reference if ref else attention_bwd
            dq, dk_lane, dv_lane = bwd(ctx.plan, q, k, v, out, lse, g, **kw)
            dk = scatter_lanes(ctx.plan, dk_lane, k.shape[0])
            dv = scatter_lanes(ctx.plan, dv_lane, v.shape[0])
        else:
            d_row = (g * out.float()).sum(-1)  # D = rowsum(dO o out), float32
            if ctx.needs_input_grad[0]:
                dq_fn = attention_dq_reference if ref else attention_dq
                dq = dq_fn(ctx.plan, q, k, v, g, lse, d_row, **kw)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                dkv_fn = attention_dkv_reference if ref else attention_dkv
                dk, dv = dkv_fn(ctx.plan_t, q, k, v, g, lse, d_row, **kw)
        grads = [t if t is None else t.to(x.dtype) for t, x in ((dq, q), (dk, k), (dv, v))]
        return (*grads, None, None, None, None, None)


def spmm_attention_ad(plan: SpmmPlan, q, k, v, *, plan_t: SpmmPlan | None = None,
                      scale: float | None = None, negative_slope: float = 1.0,
                      compute_dtype=None, precision=None, impl: str = "auto"):
    """Differentiable fused attention of one head (gradients for q, k and
    v): exactly `spmm_attention` forward (K9), saving out and lse, never a
    per-edge tensor. With plan_t (csr_preprocess of A^T; the same object
    for a symmetric graph) the backward is split: K11 over `plan` for dq
    and K12 over `plan_t` for dk and dv. Without it, K10 emits dq and the
    per-lane dk and dv planes, which `scatter_lanes` sums by hind. impl:
    "auto" (the kernels on the card, the plain versions on the CPU) or
    "reference" (the plain versions)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: it takes {', '.join(IMPLS)}")
    _refuse_knobs(compute_dtype, precision)
    dk = _check_single(plan, q, k, v, "spmm_attention_ad")[2]
    if plan_t is not None:
        _check_plan(plan_t, "spmm_attention_ad")
        if (plan_t.num_nodes, plan_t.source_rows) != (plan.source_rows, plan.num_nodes):
            raise ValueError("plan_t must be the transpose of plan (its rows are plan's "
                             "source rows and its columns plan's rows)")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else float(scale)
    return _AttentionFunction.apply(q, k, v, plan, plan_t, scale, float(negative_slope), impl)

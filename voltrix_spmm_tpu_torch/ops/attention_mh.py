"""Multi-head fused graph attention on the binned plan: kernels K13, K14
and K15, their wrappers, plain versions and gradient (counterpart of
voltrix_spmm_tpu/ops/attention_mh.py).

For head h, destination row r and its in-neighbours l (the plan's set
bits; duplicate CSR edges collapse):

    raw = q[h, r] . k[h, l],  s = act(scale * raw)  (leaky_relu, slope 1 = identity)
    out[h, r] = sum_l exp(s - m_r) v[h, l] / max(l_r, 1e-30),  lse[h, r] = m_r + log(l_r)

A row with no edges, and every row of an empty window, gets out 0 and
lse exactly 1e30.

- `spmm_attention_mh(plan, q, k, v)` runs K13 (csrc/attn_mh_fwd.cu,
  replacing attention_mh.py:_attn_fwd_mh_kernel).
- `attention_mh_dq` runs K14 (csrc/attn_mh_dq.cu, replacing
  _attn_bwd_dq_mh_kernel): dq[h, r] = sum_l ds k[h, l] over `plan`, with
  p = exp(s - lse_r), ds = p (dO_r . v_l - D_r) act'(raw) scale and
  D_r = dO_r . out_r.
- `attention_mh_dkv` runs K15 (csrc/attn_mh_dkv.cu, replacing
  _attn_bwd_dkv_mh_kernel) over the transpose plan: dk[h, l] = sum_r ds
  q[h, r] and dv[h, l] = sum_r p dO[h, r].
- `spmm_attention_mh_ad` is the autograd Function over the three.

plane_dtype=torch.bfloat16 rounds exactly the operands the JAX package
streams in bf16: k and v everywhere, q and dO where K15 gathers them.
K13's q and K14's q and dO stay float32; all sums are float32.

A CPU tensor takes the plain versions (`spmm_attention_mh_reference`,
`attention_mh_dq_reference`, `attention_mh_dkv_reference`), which take
the edges from the bitmask, compute scores by gather, the row maxima and
denominators by segment reductions, and aggregate with `index_add_`. A
CUDA tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.plan import SpmmPlan
from ..jit import build
from .bitmask import expand_bitmask
from .block_spmm import _INT_MAX, launch
from .reference import CHUNK_BYTES
from .weighted import _SMEM_LIMIT

_NEG = -1e30  # finite -inf stand-in: exp(_NEG - m) underflows to 0
_EMPTY_LSE = 1e30  # lse of a row with no edges: exp(s - 1e30) = 0
# plan blocks and heads per thread block, by kernel: the fastest of
# python3 -m voltrix_spmm_tpu_torch.tools.attn_task_sweep at path G's shapes
_TASK_BLOCKS = {"attn_mh_fwd": 8, "attn_mh_dq": 1, "attn_mh_dkv": 2}
_HEAD_GROUP = {"attn_mh_fwd": 1, "attn_mh_dq": 8, "attn_mh_dkv": 1}
_MAX_TILE_COLS = 128  # widest column chunk of a kernel's shared-memory row tile
_BATCH = 512  # edges a kernel sorts by row at once (kBatch in csrc/attn_mh_common.cuh)
# dynamic shared memory left beside the edge walks' static scratch (kSmemLimit there)
_SMEM = _SMEM_LIMIT - 4 * (2 * 256 + 33) - 16
IMPLS = ("auto", "reference")


def _loader(name: str, symbol: str, argtypes):
    @functools.cache
    def load():
        rt = build(name, [f"{name}.cu"])
        return (rt.function(symbol, argtypes),
                rt.function("voltrix_cuda_error_string", [ctypes.c_int], ctypes.c_char_p))

    load.__doc__ = f"Build (or reuse) {name}'s library; return (launch, error_string)."
    return load


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# bitmask hind wob block_ptr, then the kernel's tensors, then the geometry
load_fwd_library = _loader("attn_mh_fwd", "voltrix_attn_mh_fwd",
                           [_p] * 11 + [_i] * 13 + [_f, _f, _i, _i, _i, _p])
load_dq_library = _loader("attn_mh_dq", "voltrix_attn_mh_dq",
                          [_p] * 11 + [_i] * 13 + [_f, _f, _i, _i, _i, _p])
load_dkv_library = _loader("attn_mh_dkv", "voltrix_attn_mh_dkv",
                           [_p] * 12 + [_i] * 13 + [_f, _f, _i, _i, _i, _p])


# --- arguments -----------------------------------------------------------

def _plane(plane_dtype):
    """torch.bfloat16 for bf16 planes, None for float32 ones."""
    if plane_dtype is None or plane_dtype == torch.float32:
        return None
    if plane_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(
        f"plane_dtype must be None, torch.float32 or torch.bfloat16, not {plane_dtype}")


def _rounded(x: torch.Tensor, pdt) -> torch.Tensor:
    """x in float32, rounded through the plane dtype when there is one."""
    return x.float() if pdt is None else x.to(pdt).float()


def _check_plan(plan: SpmmPlan, name: str) -> None:
    if not isinstance(plan, SpmmPlan):
        raise TypeError(f"{name} takes an SpmmPlan, got {type(plan).__name__}")
    if plan.values is not None:
        raise ValueError(
            f"{name}: attention computes its edge values from q . k; a value "
            "plane on the plan would be silently ignored"
        )
    if plan.src_perm is not None or plan.config.seg_interleaved:
        raise ValueError(f"{name} takes plans in natural lane order only")


def _check_qkv(plan: SpmmPlan, q, k, v, name: str):
    _check_plan(plan, name)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name} takes (H, n, d) stacks")
    heads, nq, dk = q.shape
    nk = k.shape[1]
    if tuple(k.shape) != (heads, nk, dk) or tuple(v.shape[:2]) != (heads, nk):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if nk != plan.source_rows or nq != plan.num_nodes:
        raise ValueError(f"{name}: q has {nq} rows and k {nk}; the plan has {plan.num_nodes} "
                         f"rows and gathers from {plan.source_rows}")
    return heads, nq, nk, dk, v.shape[2]


def _refuse_unported(subtile, compute_dtype, precision) -> None:
    if subtile:
        raise NotImplementedError(
            "subtile=True (the sub-window skip of K13-K15) is not ported: ROADMAP.md item 13"
        )
    if precision is not None:
        raise NotImplementedError(
            "precision: a TPU matmul knob; the H100 kernels compute in float32 "
            "(the H100 tuner is ROADMAP.md item 9)"
        )
    if compute_dtype is not None and compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: the port's kernels compute in float32; "
            "bf16 streams are for the H100 tuner, ROADMAP.md item 9"
        )


# --- the plain versions ----------------------------------------------------

def _edges(plan: SpmmPlan, chunk_bytes: int = CHUNK_BYTES):
    """(rows, cols) int64 of the plan's set bits, block by block: row
    wob * block_h + 32 * w + s, column hind[lane] (clipped, as the JAX
    gather clips a tail lane)."""
    cfg = plan.config
    bh, bw = cfg.block_h, cfg.block_w
    wob = plan.window_of_block.long()
    hind = plan.hind.long().clamp(0, max(plan.source_rows - 1, 0))
    step = max(1, chunk_bytes // (8 * bh * bw))
    rows, cols = [], []
    for b0 in range(0, plan.total_blocks, step):
        b1 = min(plan.total_blocks, b0 + step)
        blk, r, j = expand_bitmask(plan.bitmask[b0:b1], bh, torch.bool).nonzero(as_tuple=True)
        rows.append(wob[b0 + blk] * bh + r)
        cols.append(hind[b0 + blk, j])
    empty = torch.zeros(0, dtype=torch.long, device=plan.device)
    return (torch.cat(rows) if rows else empty), (torch.cat(cols) if cols else empty)


def _edge_chunks(n_edges: int, heads: int, width: int, chunk_bytes: int):
    step = max(1, chunk_bytes // (4 * heads * max(width, 1) + 32))
    for e0 in range(0, n_edges, step):
        yield e0, min(n_edges, e0 + step)


def _act(raw: torch.Tensor, scale: float, slope: float) -> torch.Tensor:
    s = raw * scale
    return s if slope == 1.0 else torch.where(s > 0, s, s * slope)


def _ds(p, dp, d_row, raw, scale: float, slope: float) -> torch.Tensor:
    ds = p * (dp - d_row)
    if slope != 1.0:
        ds = ds * torch.where(raw > 0, 1.0, slope)
    return ds * scale


def spmm_attention_mh_reference(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                                negative_slope: float = 1.0, plane_dtype=None,
                                return_stats: bool = False, out_dtype=None,
                                chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K13: out (H, num_nodes, dv) and, with
    return_stats, lse (H, padded_nodes); scores by gather over the plan's
    edges, row maxima by `scatter_reduce("amax")`, denominators and the
    aggregation by `index_add_`, in chunks of about `chunk_bytes`."""
    spmm_attention_mh_reference.calls += 1
    heads, nq, _, dk, dv = _check_qkv(plan, q, k, v, "spmm_attention_mh_reference")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out_dtype = v.dtype if out_dtype is None else out_dtype
    pdt = _plane(plane_dtype)
    padded, dev = plan.padded_nodes, q.device
    qf, kf, vf = q.float(), _rounded(k, pdt), _rounded(v, pdt)
    rows, cols = _edges(plan, chunk_bytes)
    s_all = torch.empty(heads, rows.numel(), dtype=torch.float32, device=dev)
    m = torch.full((heads, padded), _NEG, dtype=torch.float32, device=dev)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 2 * dk + dv, chunk_bytes):
        r, c = rows[e0:e1], cols[e0:e1]
        raw = (qf.index_select(1, r) * kf.index_select(1, c)).sum(-1)
        s_all[:, e0:e1] = _act(raw, scale, negative_slope)
        m.scatter_reduce_(1, r.expand(heads, -1), s_all[:, e0:e1], "amax")
    p_all = torch.exp(s_all - m.index_select(1, rows))
    del s_all
    l = torch.zeros(heads, padded, dtype=torch.float32, device=dev).index_add_(1, rows, p_all)
    acc = torch.zeros(heads, padded, dv, dtype=torch.float32, device=dev)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 2 * dv, chunk_bytes):
        c = cols[e0:e1]
        acc.index_add_(1, rows[e0:e1], p_all[:, e0:e1, None] * vf.index_select(1, c))
    out = (acc / l.clamp_min(1e-30)[..., None])[:, :nq].to(out_dtype)
    if not return_stats:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), _EMPTY_LSE)
    return out, lse


spmm_attention_mh_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def _check_bwd(plan, q, k, v, g, lse, d_row, name, transposed):
    """Shapes of the backward's inputs; `plan` is A (K14) or A^T (K15)."""
    _check_plan(plan, name)
    heads, nq, dk = q.shape
    nk, dv = k.shape[1], v.shape[2]
    rows, src = (nk, nq) if transposed else (nq, nk)
    if (plan.num_nodes, plan.source_rows) != (rows, src):
        raise ValueError(f"{name}: the plan is {plan.num_nodes} x {plan.source_rows}, the "
                         f"problem {rows} x {src}")
    want = {"k": (heads, nk, dk), "v": (heads, nk, dv), "g": (heads, nq, dv),
            "d_row": (heads, nq)}
    for label, t in (("k", k), ("v", v), ("g", g), ("d_row", d_row)):
        if tuple(t.shape) != want[label]:
            raise ValueError(f"{name}: {label} must be {want[label]}, got {tuple(t.shape)}")
    if lse.dim() != 2 or lse.shape[0] != heads or lse.shape[1] < nq:
        raise ValueError(f"{name}: lse must be (H, >= {nq}), got {tuple(lse.shape)}")
    return heads, nq, nk, dk, dv


def attention_mh_dq_reference(plan: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                              negative_slope: float = 1.0, plane_dtype=None,
                              chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K14: dq (H, num_nodes, dk) float32 over `plan`,
    from the forward's lse and D = rowsum(dO o out)."""
    attention_mh_dq_reference.calls += 1
    heads, nq, _, dk, dv = _check_bwd(plan, q, k, v, g, lse, d_row,
                                      "attention_mh_dq_reference", False)
    pdt = _plane(plane_dtype)
    qf, kf, vf, gf = q.float(), _rounded(k, pdt), _rounded(v, pdt), g.float()
    lse, d_row = lse.float(), d_row.float()
    rows, cols = _edges(plan, chunk_bytes)
    dq = torch.zeros(heads, nq, dk, dtype=torch.float32, device=q.device)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 3 * dk + 2 * dv, chunk_bytes):
        r, c = rows[e0:e1], cols[e0:e1]
        kc = kf.index_select(1, c)
        raw = (qf.index_select(1, r) * kc).sum(-1)
        p = torch.exp(_act(raw, scale, negative_slope) - lse.index_select(1, r))
        dp = (gf.index_select(1, r) * vf.index_select(1, c)).sum(-1)
        ds = _ds(p, dp, d_row.index_select(1, r), raw, scale, negative_slope)
        dq.index_add_(1, r, ds[..., None] * kc)
    return dq


attention_mh_dq_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def attention_mh_dkv_reference(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                               negative_slope: float = 1.0, plane_dtype=None,
                               chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K15: (dk, dv) float32 over the transpose plan,
    whose rows are the source rows of k and v and whose lanes are the
    destination rows of q, dO, lse and D."""
    attention_mh_dkv_reference.calls += 1
    heads, _, nk, dk, dv = _check_bwd(plan_t, q, k, v, g, lse, d_row,
                                      "attention_mh_dkv_reference", True)
    pdt = _plane(plane_dtype)
    qf, kf, vf, gf = (_rounded(t, pdt) for t in (q, k, v, g))
    lse, d_row = lse.float(), d_row.float()
    rows, cols = _edges(plan_t, chunk_bytes)  # rows index k and v, cols q and dO
    dk_out = torch.zeros(heads, nk, dk, dtype=torch.float32, device=q.device)
    dv_out = torch.zeros(heads, nk, dv, dtype=torch.float32, device=q.device)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 3 * dk + 3 * dv, chunk_bytes):
        s, r = rows[e0:e1], cols[e0:e1]
        qc, gc = qf.index_select(1, r), gf.index_select(1, r)
        raw = (kf.index_select(1, s) * qc).sum(-1)
        p = torch.exp(_act(raw, scale, negative_slope) - lse.index_select(1, r))
        dv_out.index_add_(1, s, p[..., None] * gc)
        dp = (vf.index_select(1, s) * gc).sum(-1)
        ds = _ds(p, dp, d_row.index_select(1, r), raw, scale, negative_slope)
        dk_out.index_add_(1, s, ds[..., None] * qc)
    return dk_out, dv_out


attention_mh_dkv_reference.calls = 0  # plain-int call count, read by chip_smoke.py


# --- the kernels -------------------------------------------------------------

def _plan_args(plan: SpmmPlan, device, name: str):
    """The plan's arrays as pointers, after checking what K13-K15 read."""
    cfg = plan.config
    shapes = {
        "bitmask": (plan.total_blocks, cfg.words_per_col, cfg.block_w),
        "hind": (plan.total_blocks, cfg.block_w),
        "window_of_block": (plan.total_blocks,),
        "block_ptr": (plan.num_windows + 1,),
    }
    for field, shape in shapes.items():
        t = getattr(plan, field)
        if t.device != device:
            raise ValueError(f"plan.{field} is on {t.device}, the tensors on {device}: move "
                             "the plan once with SpmmPlan.to(device)")
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"plan.{field} must be contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if max(plan.padded_nodes, plan.source_rows, plan.total_blocks) > _INT_MAX:
        raise ValueError(f"{name} indexes rows and blocks with 32-bit ints")
    return [getattr(plan, f).data_ptr() for f in shapes]


def _tensors(name: str, device, *pairs):
    """Each (tensor, dtype) as a contiguous tensor of that dtype on `device`."""
    out = []
    for t, dtype in pairs:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        out.append(t.to(dtype).contiguous())
    return out


def _geometry(block_h: int, heads: int, width: int, fixed, name: str) -> tuple[int, int]:
    """(head_group, dc) of a kernel: up to _HEAD_GROUP[name] heads (at
    most 8) per thread block and dc <= _MAX_TILE_COLS columns of its
    (head_group x block_h x dc) shared-memory tile, dc halved (then the
    group) until the tile and fixed(head_group) other floats fit."""
    hg = max(1, min(heads, _HEAD_GROUP[name]))
    while True:
        dc = max(1, min(width, _MAX_TILE_COLS))
        while (hg * block_h * (dc | 1) + fixed(hg)) * 4 > _SMEM and dc > 1:
            dc = (dc + 1) // 2
        if (hg * block_h * (dc | 1) + fixed(hg)) * 4 <= _SMEM:
            return hg, dc
        if hg == 1:
            raise ValueError(f"{name}: a {block_h}-row tile does not fit one thread block's "
                             "shared memory; use a shorter block_h")
        hg //= 2


def _vec4(d: int, *tensors) -> int:
    """1 when rows of width d may be read four values at a time."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")
    return True


def _mh_fwd_kernel(plan, q, k, v, scale, slope, pdt):
    """out (H, nq, dv) and lse (H, padded_nodes), float32, through K13."""
    heads, nq, nk, dk, dv = q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2]
    dev = q.device
    plan_ptrs = _plan_args(plan, dev, "spmm_attention_mh")
    tdt = pdt or torch.float32
    qc, kc, vc = _tensors("spmm_attention_mh", dev, (q, torch.float32), (k, tdt), (v, tdt))
    cfg = plan.config
    out = torch.zeros(heads, nq, dv, dtype=torch.float32, device=dev)
    lse = torch.full((heads, plan.padded_nodes), _EMPTY_LSE, dtype=torch.float32, device=dev)
    if dv == 0:
        return out, lse
    # m, l and a rescale per head, row counts and offsets; p per head and
    # the source row of a batch's edges
    bh = cfg.block_h
    hg, dc = _geometry(bh, heads, dv, lambda g: 3 * g * bh + 2 * bh + 1 + (g + 1) * _BATCH,
                       "attn_mh_fwd")
    nchunks, ngroups = -(-dv // dc), -(-heads // hg)
    tasks = -(-plan.total_blocks // _TASK_BLOCKS["attn_mh_fwd"])
    if ngroups > 65535 or nchunks > 65535:
        raise ValueError("spmm_attention_mh: heads or dv exceed the grid's limits")
    part = torch.empty(2 * tasks * heads * nchunks * bh * (dc + 2),
                       dtype=torch.float32, device=dev)
    count = torch.zeros(plan.num_windows * ngroups * nchunks, dtype=torch.int32, device=dev)
    launch(
        "attn_mh_fwd", load_fwd_library(), q,
        *plan_ptrs, qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        lse.data_ptr(), part.data_ptr(), count.data_ptr(),
        plan.total_blocks, cfg.words_per_col, bh, cfg.block_w, plan.num_windows,
        heads, hg, nq, nk, dk, dv, dc, _TASK_BLOCKS["attn_mh_fwd"], float(scale),
        float(slope), _vec4(dk, qc, kc), _vec4(dv, vc), int(pdt is not None),
    )
    spmm_attention_mh.launches += 1
    return out, lse


def spmm_attention_mh(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                      negative_slope: float = 1.0, compute_dtype=None, precision=None,
                      plane_dtype=None, return_stats: bool = False, subtile: bool = False,
                      out_dtype=None):
    """All-head fused attention aggregation through kernel K13: per head
    h, out[h, r] = softmax over r's in-neighbours l of act(scale q[h, r] .
    k[h, l]), applied to v[h]. q (H, num_nodes, dk), k (H, source_rows,
    dk), v (H, source_rows, dv); returns (H, num_nodes, dv) in `out_dtype`
    (default v's) and, with return_stats, lse (H, padded_nodes) float32.
    scale defaults to 1/sqrt(dk); negative_slope 1.0 is the identity.
    plane_dtype=torch.bfloat16 rounds k and v to bf16. A plan with a value
    plane is refused (ValueError), as the single-head op refuses it."""
    _refuse_unported(subtile, compute_dtype, precision)
    heads, nq, _, dk, dv = _check_qkv(plan, q, k, v, "spmm_attention_mh")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out_dtype = v.dtype if out_dtype is None else out_dtype
    pdt = _plane(plane_dtype)
    if plan.total_blocks == 0:
        out = torch.zeros(heads, nq, dv, dtype=out_dtype, device=q.device)
        if return_stats:
            return out, torch.full((heads, plan.padded_nodes), _EMPTY_LSE,
                                   dtype=torch.float32, device=q.device)
        return out
    if not _on_cuda(q, "spmm_attention_mh"):
        return spmm_attention_mh_reference(plan, q, k, v, scale=scale,
                                           negative_slope=negative_slope, plane_dtype=pdt,
                                           return_stats=return_stats, out_dtype=out_dtype)
    out, lse = _mh_fwd_kernel(plan, q, k, v, scale, negative_slope, pdt)
    out = out.to(out_dtype)
    return (out, lse) if return_stats else out


spmm_attention_mh.launches = 0  # plain-int launch count, read by chip_smoke.py


def attention_mh_dq(plan: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                    negative_slope: float = 1.0, plane_dtype=None) -> torch.Tensor:
    """dq (H, num_nodes, dk) float32 through kernel K14 over `plan` (see
    the plain version)."""
    if not _on_cuda(q, "attention_mh_dq"):
        return attention_mh_dq_reference(plan, q, k, v, g, lse, d_row, scale=scale,
                                         negative_slope=negative_slope, plane_dtype=plane_dtype)
    heads, nq, nk, dk, dv = _check_bwd(plan, q, k, v, g, lse, d_row, "attention_mh_dq", False)
    pdt = _plane(plane_dtype)
    dev = q.device
    plan_ptrs = _plan_args(plan, dev, "attention_mh_dq")
    tdt = pdt or torch.float32
    f32 = torch.float32
    qc, kc, vc, gc, lc, dc_row = _tensors("attention_mh_dq", dev, (q, f32), (k, tdt), (v, tdt),
                                          (g, f32), (lse, f32), (d_row, f32))
    cfg = plan.config
    dq = torch.zeros(heads, nq, dk, dtype=torch.float32, device=dev)
    if plan.total_blocks == 0 or dk == 0:
        return dq
    bh = cfg.block_h
    hg, dc = _geometry(bh, heads, dk, lambda g: 2 * bh + 1 + (g + 1) * _BATCH,
                       "attn_mh_dq")
    if -(-heads // hg) > 65535 or -(-dk // dc) > 65535:
        raise ValueError("attention_mh_dq: heads or dk exceed the grid's limits")
    launch(
        "attn_mh_dq", load_dq_library(), q,
        *plan_ptrs, qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
        lc.data_ptr(), dc_row.data_ptr(), dq.data_ptr(),
        plan.total_blocks, cfg.words_per_col, bh, cfg.block_w, heads, hg, nq, nk,
        lc.shape[1], dk, dv, dc, _TASK_BLOCKS["attn_mh_dq"], float(scale),
        float(negative_slope), _vec4(dk, qc, kc), _vec4(dv, gc, vc), int(pdt is not None),
    )
    attention_mh_dq.launches += 1
    return dq


attention_mh_dq.launches = 0  # plain-int launch count, read by chip_smoke.py


def attention_mh_dkv(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                     negative_slope: float = 1.0, plane_dtype=None):
    """(dk, dv) float32 through kernel K15 over the transpose plan (see
    the plain version)."""
    if not _on_cuda(q, "attention_mh_dkv"):
        return attention_mh_dkv_reference(plan_t, q, k, v, g, lse, d_row, scale=scale,
                                          negative_slope=negative_slope,
                                          plane_dtype=plane_dtype)
    heads, nq, nk, dk, dv = _check_bwd(plan_t, q, k, v, g, lse, d_row, "attention_mh_dkv", True)
    pdt = _plane(plane_dtype)
    dev = q.device
    plan_ptrs = _plan_args(plan_t, dev, "attention_mh_dkv")
    tdt = pdt or torch.float32
    f32 = torch.float32
    qc, kc, vc, gc, lc, dc_row = _tensors("attention_mh_dkv", dev, (q, tdt), (k, tdt), (v, tdt),
                                          (g, tdt), (lse, f32), (d_row, f32))
    cfg = plan_t.config
    dk_out = torch.zeros(heads, nk, dk, dtype=torch.float32, device=dev)
    dv_out = torch.zeros(heads, nk, dv, dtype=torch.float32, device=dev)
    if plan_t.total_blocks == 0 or dk + dv == 0:
        return dk_out, dv_out
    bh = cfg.block_h
    hg, dc = _geometry(bh, heads, dk + dv, lambda g: 2 * bh + 1 + (2 * g + 1) * _BATCH,
                       "attn_mh_dkv")
    if -(-heads // hg) > 65535 or -(-(dk + dv) // dc) > 65535:
        raise ValueError("attention_mh_dkv: heads or dk + dv exceed the grid's limits")
    launch(
        "attn_mh_dkv", load_dkv_library(), q,
        *plan_ptrs, kc.data_ptr(), vc.data_ptr(), qc.data_ptr(), gc.data_ptr(),
        lc.data_ptr(), dc_row.data_ptr(), dk_out.data_ptr(), dv_out.data_ptr(),
        plan_t.total_blocks, cfg.words_per_col, bh, cfg.block_w, heads, hg, nk, nq,
        lc.shape[1], dk, dv, dc, _TASK_BLOCKS["attn_mh_dkv"], float(scale),
        float(negative_slope), _vec4(dk, kc, qc), _vec4(dv, vc, gc), int(pdt is not None),
    )
    attention_mh_dkv.launches += 1
    return dk_out, dv_out


attention_mh_dkv.launches = 0  # plain-int launch count, read by chip_smoke.py


# --- the gradient --------------------------------------------------------------

class _AttentionMHFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, plan, plan_t, scale, slope, pdt, impl):
        ctx.plan, ctx.plan_t, ctx.scale, ctx.slope, ctx.pdt, ctx.impl = (
            plan, plan_t, scale, slope, pdt, impl)
        fwd = spmm_attention_mh_reference if impl == "reference" else spmm_attention_mh
        out, lse = fwd(plan, q, k, v, scale=scale, negative_slope=slope, plane_dtype=pdt,
                       return_stats=True)
        # residuals are O(n): the inputs, out and lse; no per-edge tensor
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.float().contiguous()
        d_row = (g * out.float()).sum(-1)  # D = rowsum(dO o out), float32
        kw = dict(scale=ctx.scale, negative_slope=ctx.slope, plane_dtype=ctx.pdt)
        ref = ctx.impl == "reference"
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq_fn = attention_mh_dq_reference if ref else attention_mh_dq
            dq = dq_fn(ctx.plan, q, k, v, g, lse, d_row, **kw).to(q.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dkv_fn = attention_mh_dkv_reference if ref else attention_mh_dkv
            dk, dv = dkv_fn(ctx.plan_t, q, k, v, g, lse, d_row, **kw)
            dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def spmm_attention_mh_ad(plan: SpmmPlan, q, k, v, *, plan_t: SpmmPlan, scale: float | None = None,
                         negative_slope: float = 1.0, compute_dtype=None, precision=None,
                         plane_dtype=None, subtile: bool = False, impl: str = "auto"):
    """Differentiable all-head fused attention (gradients for the q, k
    and v stacks). Forward K13 (saving out and lse, never a per-edge
    tensor); backward K14 over `plan` for dq and K15 over `plan_t`
    (csr_preprocess of A^T; the same object for a symmetric graph) for dk
    and dv. impl: "auto" (the kernels on the card, the plain versions on
    the CPU) or "reference" (the plain versions)."""
    if plan_t is None:
        raise ValueError(
            "spmm_attention_mh_ad requires plan_t (csr_preprocess of A^T): the backward "
            "runs dK/dV over the transpose plan"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: it takes {', '.join(IMPLS)}")
    _refuse_unported(subtile, compute_dtype, precision)
    dk = _check_qkv(plan, q, k, v, "spmm_attention_mh_ad")[3]
    _check_plan(plan_t, "spmm_attention_mh_ad")
    if (plan_t.num_nodes, plan_t.source_rows) != (plan.source_rows, plan.num_nodes):
        raise ValueError("plan_t must be the transpose of plan")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else float(scale)
    return _AttentionMHFunction.apply(q, k, v, plan, plan_t, scale, float(negative_slope),
                                      _plane(plane_dtype), impl)

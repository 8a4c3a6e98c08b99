"""The pieces the fused-attention ops share over (H, n, d) stacks: the
plain versions' arithmetic, the argument checks and the launches of the
kernels of K14 and K15 (csrc/attn_mh_dq.cu, csrc/attn_mh_dkv.cu).

ops/attention_mh.py launches them over H heads with float32 or bf16
planes; ops/attention.py launches them with H = 1 and float32 planes as
K11 and K12 (the JAX package keeps a single-head and a multi-head copy of
each Pallas kernel only because the TPU pays one gather call per head).
All of K9-K15 walk rows with csrc/attn_walk.cuh; K9 and K10 are launched
by ops/attention.py, K13 by ops/attention_mh.py. The launch functions are
the bodies of the registered ops (ops/library.py) on the card: they take
the entry point whose op calls them and its work list, built from the
real plan beside the op's operands; the entry's name keys the work list
(ops/block_spmm.py: PIECE_BLOCKS, PIECE_WORK), the head group and the
messages, and its `launches` count goes up by one where the kernel
launches, and nowhere else.
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


_NEG = -1e30  # finite -inf stand-in: exp(_NEG - m) underflows to 0
_EMPTY_LSE = 1e30  # lse of a row with no edges: exp(s - 1e30) = 0
# heads whose walk K14 and K15 share (1, 2 or 4): the fastest of
# python3 -m voltrix_spmm_tpu_torch.tools.attn_task_sweep --kernels backward
# at path G's layer 1 (the one-head entry points K11 and K12 take 1)
BWD_HEAD_GROUP = {"attention_mh_dq": 2, "attention_mh_dkv": 2}
# K14's and K15's column chunks (a lane's columns of dq, or of dk and of
# dv, per head) by head group: the template pairs of csrc/attn_mh_dq.cu
# and csrc/attn_mh_dkv.cu, whose registers fit a lane
BWD_ACC_WIDTHS = {1: (8, 16, 32, 40, 64), 2: (8, 16), 4: (8,)}
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
_ll = ctypes.c_longlong
# the plan's arrays and the work list, the kernel's tensors, the geometry,
# the alignment flags, then the (head, row) strides of the four stacks
load_dq_library = _loader("attn_mh_dq", "voltrix_attn_mh_dq",
                          [_p] * 12 + [_i] * 15 + [_f, _f] + [_i] * 4 + [_ll] * 8 + [_p])
load_dkv_library = _loader("attn_mh_dkv", "voltrix_attn_mh_dkv",
                           [_p] * 14 + [_i] * 15 + [_f, _f] + [_i] * 4 + [_ll] * 8 + [_p])


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


def _refuse_knobs(compute_dtype, precision, block_d=None, interpret=None) -> None:
    """The JAX package's TPU knobs: the H100 kernels pick their own tiles,
    compute in float32, and have no interpret mode."""
    if block_d is not None:
        raise NotImplementedError(
            "block_d: a TPU tiling knob; the H100 kernels pick their own tiles (their "
            "piece limits and head groups as tuner knobs are ROADMAP.md item 9)"
        )
    if precision is not None:
        raise NotImplementedError(
            "precision: a TPU matmul knob; the H100 kernels compute in float32 "
            "(ROADMAP.md item 9)"
        )
    if compute_dtype is not None and compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: the attention kernels K9-K15 compute in "
            "float32; bf16 planes are `plane_dtype`, their compute_dtype ROADMAP.md item 9"
        )
    if interpret is not None:
        raise NotImplementedError(
            "interpret: Pallas's interpret mode; the port launches the kernel on a CUDA "
            "tensor and runs its plain version on a CPU tensor"
        )


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


def _check_bwd(plan, q, k, v, g, lse, d_row, name, transposed):
    """Shapes of the backward's inputs; `plan` is A (dq) or A^T (dk, dv).
    d_row None: K10, which takes out and computes D itself."""
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
        if t is not None and tuple(t.shape) != want[label]:
            raise ValueError(f"{name}: {label} must be {want[label]}, got {tuple(t.shape)}")
    if lse.dim() != 2 or lse.shape[0] != heads or lse.shape[1] < nq:
        raise ValueError(f"{name}: lse must be (H, >= {nq}), got {tuple(lse.shape)}")
    return heads, nq, nk, dk, dv



# --- the edges -------------------------------------------------------------

def _edges(plan: SpmmPlan, chunk_bytes: int = CHUNK_BYTES):
    """(rows, cols, lanes) int64 of the plan's set bits, block by block:
    row wob * block_h + 32 * w + s, column hind[lane] (clipped, as the JAX
    gather clips a tail lane), lane b * block_w + j."""
    cfg = plan.config
    bh, bw = cfg.block_h, cfg.block_w
    wob = plan.window_of_block.long()
    hind = plan.hind.long().clamp(0, max(plan.source_rows - 1, 0))
    step = max(1, chunk_bytes // (8 * bh * bw))
    rows, cols, lanes = [], [], []
    for b0 in range(0, plan.total_blocks, step):
        b1 = min(plan.total_blocks, b0 + step)
        blk, r, j = expand_bitmask(plan.bitmask[b0:b1], bh, torch.bool).nonzero(as_tuple=True)
        rows.append(wob[b0 + blk] * bh + r)
        cols.append(hind[b0 + blk, j])
        lanes.append((b0 + blk) * bw + j)
    empty = torch.zeros(0, dtype=torch.long, device=plan.device)
    return tuple(torch.cat(x) if x else empty for x in (rows, cols, lanes))


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


# --- the plain versions, over (H, n, d) stacks -------------------------------

def _fwd_plain(plan: SpmmPlan, q, k, v, scale, slope, pdt, chunk_bytes):
    """out (H, num_nodes, dv) and lse (H, padded_nodes), float32: scores by
    gather over the plan's edges, row maxima by `scatter_reduce("amax")`,
    denominators and the aggregation by `index_add_`, in chunks of about
    `chunk_bytes`."""
    heads, nq, dk, dv = q.shape[0], q.shape[1], q.shape[2], v.shape[2]
    padded, dev = plan.padded_nodes, q.device
    qf, kf, vf = q.float(), _rounded(k, pdt), _rounded(v, pdt)
    rows, cols, _ = _edges(plan, chunk_bytes)
    s_all = torch.empty(heads, rows.numel(), dtype=torch.float32, device=dev)
    m = torch.full((heads, padded), _NEG, dtype=torch.float32, device=dev)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 2 * dk + dv, chunk_bytes):
        r, c = rows[e0:e1], cols[e0:e1]
        raw = (qf.index_select(1, r) * kf.index_select(1, c)).sum(-1)
        s_all[:, e0:e1] = _act(raw, scale, slope)
        m.scatter_reduce_(1, r.expand(heads, -1), s_all[:, e0:e1], "amax")
    p_all = torch.exp(s_all - m.index_select(1, rows))
    del s_all
    l = torch.zeros(heads, padded, dtype=torch.float32, device=dev).index_add_(1, rows, p_all)
    acc = torch.zeros(heads, padded, dv, dtype=torch.float32, device=dev)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 2 * dv, chunk_bytes):
        c = cols[e0:e1]
        acc.index_add_(1, rows[e0:e1], p_all[:, e0:e1, None] * vf.index_select(1, c))
    out = (acc / l.clamp_min(1e-30)[..., None])[:, :nq]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), _EMPTY_LSE)
    return out, lse


def _dq_plain(plan: SpmmPlan, q, k, v, g, lse, d_row, scale, slope, pdt, chunk_bytes):
    """dq (H, num_nodes, dk) float32 over `plan`, from the forward's lse and
    D = rowsum(dO o out)."""
    heads, nq, dk, dv = q.shape[0], q.shape[1], q.shape[2], v.shape[2]
    qf, kf, vf, gf = q.float(), _rounded(k, pdt), _rounded(v, pdt), g.float()
    lse, d_row = lse.float(), d_row.float()
    rows, cols, _ = _edges(plan, chunk_bytes)
    dq = torch.zeros(heads, nq, dk, dtype=torch.float32, device=q.device)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 3 * dk + 2 * dv, chunk_bytes):
        r, c = rows[e0:e1], cols[e0:e1]
        kc = kf.index_select(1, c)
        raw = (qf.index_select(1, r) * kc).sum(-1)
        p = torch.exp(_act(raw, scale, slope) - lse.index_select(1, r))
        dp = (gf.index_select(1, r) * vf.index_select(1, c)).sum(-1)
        ds = _ds(p, dp, d_row.index_select(1, r), raw, scale, slope)
        dq.index_add_(1, r, ds[..., None] * kc)
    return dq


def _dkv_plain(plan_t: SpmmPlan, q, k, v, g, lse, d_row, scale, slope, pdt, chunk_bytes):
    """(dk, dv) float32 over the transpose plan, whose rows are the source
    rows of k and v and whose lanes are the destination rows of q, dO, lse
    and D."""
    heads, nk, dk, dv = k.shape[0], k.shape[1], k.shape[2], v.shape[2]
    qf, kf, vf, gf = (_rounded(t, pdt) for t in (q, k, v, g))
    lse, d_row = lse.float(), d_row.float()
    rows, cols, _ = _edges(plan_t, chunk_bytes)  # rows index k and v, cols q and dO
    dk_out = torch.zeros(heads, nk, dk, dtype=torch.float32, device=q.device)
    dv_out = torch.zeros(heads, nk, dv, dtype=torch.float32, device=q.device)
    for e0, e1 in _edge_chunks(rows.numel(), heads, 3 * dk + 3 * dv, chunk_bytes):
        s, r = rows[e0:e1], cols[e0:e1]
        qc, gc = qf.index_select(1, r), gf.index_select(1, r)
        raw = (kf.index_select(1, s) * qc).sum(-1)
        p = torch.exp(_act(raw, scale, slope) - lse.index_select(1, r))
        dv_out.index_add_(1, s, p[..., None] * gc)
        dp = (vf.index_select(1, s) * gc).sum(-1)
        ds = _ds(p, dp, d_row.index_select(1, r), raw, scale, slope)
        dk_out.index_add_(1, s, ds[..., None] * qc)
    return dk_out, dv_out


# --- the kernels of K14 and K15, over (H, n, d) stacks -----------------------

def check_plan_arrays(plan: SpmmPlan, device, name: str) -> None:
    """Check the plan's arrays that K9-K15 read: contiguous int32 tensors
    of the plan's shapes on `device`, and rows and blocks that 32-bit ints
    index (ops/library.py checks them where it builds the ops' operands)."""
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


def _tensors(name: str, device, *pairs):
    """Each (tensor, dtype) as a contiguous tensor of that dtype on `device`
    (the tensor itself, with no copy, when it is one already)."""
    out = []
    for t, dtype in pairs:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        out.append(t.to(dtype).contiguous())
    return out


def _head_rows(name: str, device, t: torch.Tensor, dtype) -> torch.Tensor:
    """t (H, n, d) in `dtype` on `device` with each row's values contiguous,
    in whatever head and row strides it has: the node-major (n, H, d)
    projections of models/gat_flash.py as they are (no copy where the dtype
    is already right), a head-major stack likewise."""
    if t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    t = t.to(dtype)
    return t.contiguous() if t.shape[2] > 1 and t.stride(2) != 1 else t


def _rows_by(t: torch.Tensor, per: int) -> int:
    """1 when every row of the (H, n, d) stack t starts on a boundary of
    `per` values and holds whole runs of `per` values."""
    align = per * t.element_size()
    return int(t.shape[2] % per == 0 and t.data_ptr() % align == 0
               and t.stride(0) % per == 0 and t.stride(1) % per == 0)


def _rows16(t: torch.Tensor) -> int:
    """1 when t's rows may be staged by 16-byte copies."""
    return _rows_by(t, 16 // t.element_size())


def _rows4(t: torch.Tensor) -> int:
    """1 when t's rows may be read four values a load."""
    return _rows_by(t, 4)


def group_and_chunk(heads: int, d: int, group: int, widths: dict) -> tuple[int, int]:
    """(head group, column chunk) of a multi-head walk for `heads` heads of
    width d: the smallest power of two that holds min(heads, group) heads,
    halved while its widest chunk in `widths` is narrower than d; the
    narrowest chunk that holds d, else the widest (d in several chunks)."""
    hg = 1
    while hg < min(heads, group):
        hg *= 2
    while hg > 1 and widths[hg][-1] < d:
        hg //= 2
    return hg, next((w for w in widths[hg] if w >= d), widths[hg][-1])


def bwd_geometry(name: str, heads: int, d: int) -> tuple[int, int]:
    """(head group, column chunk) of K14 (d = dk) or K15 (d = max(dk, dv))
    for entry point `name`: `group_and_chunk` over BWD_ACC_WIDTHS, with
    BWD_HEAD_GROUP[name] heads at most (one for K11 and K12)."""
    return group_and_chunk(heads, d, BWD_HEAD_GROUP.get(name, 1), BWD_ACC_WIDTHS)


def _vec4(d: int, *tensors) -> int:
    """1 when rows of width d may be read four values at a time."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")
    return True


def _grid(name: str, walk, heads: int, d: int) -> tuple[int, int]:
    """(head group, column chunk) of K14 or K15 on `walk`, after checking
    that the grid takes them."""
    hg, acc = bwd_geometry(name, heads, d)
    if walk.tasks.shape[0] * -(-heads // hg) > _INT_MAX or -(-d // acc) > 65535 or heads > 65535:
        raise ValueError(f"{name}: more tasks, heads or columns than the grid takes")
    return hg, acc


def _workspace(walk, heads: int, d: int, device):
    """A cut group's pieces 1.. for each head at width d (None if no group
    is cut)."""
    if not walk.slots:
        return None
    return torch.empty(max(1, heads * walk.slots * walk.rows * d), dtype=torch.float32,
                       device=device)


def _strides(*stacks):
    return [x for t in stacks for x in t.stride()[:2]]


def _dq_kernel(entry, plan, walk, q, k, v, g, lse, d_row, scale, slope, pdt):
    """dq (H, nq, dk) float32 through K14 (csrc/attn_mh_dq.cu), the body of
    the op of `entry` (ops/library.py): the walk over `walk`
    (`plan_walk(plan, name)`) for each head group and, when a group of
    rows is cut, the merge of each head's pieces. q, k, v and dO are read
    through their head and row strides (`_head_rows`). Every row is
    written."""
    name = entry.__name__
    heads, nq, nk, dk, dv = q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2]
    dev = q.device
    f32, tdt = torch.float32, pdt or torch.float32
    qc, kc, vc, gc = (_head_rows(name, dev, t, dt)
                      for t, dt in ((q, f32), (k, tdt), (v, tdt), (g, f32)))
    lc, dc_row = _tensors(name, dev, (lse, f32), (d_row, f32))
    dq = torch.empty(heads, nq, dk, dtype=f32, device=dev)
    if plan.total_blocks == 0 or dk == 0:
        return dq.zero_()
    hg, acc = _grid(name, walk, heads, dk)
    ws = _workspace(walk, heads, dk, dev)
    cfg = plan.config
    launch(
        name, load_dq_library(), q, plan.bitmask.data_ptr(), plan.hind.data_ptr(),
        walk.tasks.data_ptr(), walk.merges.data_ptr(), qc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), gc.data_ptr(), lc.data_ptr(), dc_row.data_ptr(), dq.data_ptr(),
        None if ws is None else ws.data_ptr(), walk.tasks.shape[0], walk.merges.shape[0],
        walk.slots, heads, hg, cfg.words_per_col, cfg.block_h, cfg.block_w, nq, nk, dk, dv,
        lc.shape[1], acc, int(pdt is not None), float(scale), float(slope), _rows4(qc),
        _rows4(gc), _rows16(kc), _rows16(vc), *_strides(qc, kc, vc, gc),
    )
    entry.launches += 1
    return dq


def _dkv_kernel(entry, plan_t, walk, q, k, v, g, lse, d_row, scale, slope, pdt):
    """(dk, dv) float32 through K15 (csrc/attn_mh_dkv.cu) over the
    transpose plan, the body of the op of `entry` (ops/library.py): the
    walk over `walk` (`plan_walk(plan_t, name)`) for each head group and,
    when a group of rows is cut, the merges of each head's pieces of dk
    and of dv. q, k, v and dO are read in the plane's type
    through their head and row strides. Every row is written."""
    name = entry.__name__
    heads, nq, nk, dk, dv = q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2]
    dev = q.device
    f32, tdt = torch.float32, pdt or torch.float32
    qc, kc, vc, gc = (_head_rows(name, dev, t, tdt) for t in (q, k, v, g))
    lc, dc_row = _tensors(name, dev, (lse, f32), (d_row, f32))
    dk_out = torch.empty(heads, nk, dk, dtype=f32, device=dev)
    dv_out = torch.empty(heads, nk, dv, dtype=f32, device=dev)
    if plan_t.total_blocks == 0 or dk + dv == 0:
        return dk_out.zero_(), dv_out.zero_()
    hg, acc = _grid(name, walk, heads, max(dk, dv))
    ws_k, ws_v = (_workspace(walk, heads, d, dev) for d in (dk, dv))
    cfg = plan_t.config
    launch(
        name, load_dkv_library(), q, plan_t.bitmask.data_ptr(), plan_t.hind.data_ptr(),
        walk.tasks.data_ptr(), walk.merges.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        qc.data_ptr(), gc.data_ptr(), lc.data_ptr(), dc_row.data_ptr(), dk_out.data_ptr(),
        dv_out.data_ptr(), *(None if w is None else w.data_ptr() for w in (ws_k, ws_v)),
        walk.tasks.shape[0], walk.merges.shape[0], walk.slots, heads, hg, cfg.words_per_col,
        cfg.block_h, cfg.block_w, nk, nq, dk, dv, lc.shape[1], acc, int(pdt is not None),
        float(scale), float(slope), _rows4(kc), _rows4(vc), _rows16(qc), _rows16(gc),
        *_strides(kc, vc, qc, gc),
    )
    entry.launches += 1
    return dk_out, dv_out

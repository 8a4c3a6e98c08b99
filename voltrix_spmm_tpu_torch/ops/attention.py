"""Fused graph attention on the binned plan, one head at a time: kernels
K9, K10, K11 and K12, their wrappers, plain versions and gradient
(counterpart of voltrix_spmm_tpu/ops/attention.py). The arithmetic and
the launches K11 and K12 share with the multi-head op (ops/attention_mh.py)
are in ops/_attn_core.py.

For destination row r and its in-neighbours l (the plan's set bits;
duplicate CSR edges collapse):

    raw = q[r] . k[l],  s = act(scale * raw)  (leaky_relu, slope 1 = identity)
    out[r] = sum_l exp(s - m_r) v[l] / max(l_r, 1e-30),  lse[r] = m_r + log(l_r)

A row with no edges, and every row of an empty window, gets out 0 and
lse exactly 1e30. The backward, with p = exp(s - lse_r), D_r = dO_r .
out_r and ds = p (dO_r . v_l - D_r) act'(raw) scale:

    dq[r] = sum_l ds k[l],  dk[l] = sum_r ds q[r],  dv[l] = sum_r p dO[r]

- `spmm_attention` runs K9 (csrc/attn_fwd.cu, replacing
  attention.py:_attn_fwd_kernel): the row walk of csrc/attn_walk.cuh over
  K1's work list (`attention_walk`), each 128-row group of a window cut
  into pieces of at most PIECE_BLOCKS["spmm_attention"] blocks and about
  PIECE_WORK["spmm_attention"] units of work (ops/block_spmm.py), the
  pieces' (m, l, acc) shares of a cut group merged in piece order.
- `attention_dq` runs K11 (_attn_bwd_dq_kernel: dq over `plan`) and
  `attention_dkv` K12 (_attn_bwd_dkv_kernel: dk, dv over the transpose
  plan): the kernels of K14 and K15 (csrc/attn_mh_*.cu, the same row walk,
  each on its own work list) launched with H = 1 and float32 planes.
- `attention_bwd` runs K10 (csrc/attn_bwd.cu, replacing _attn_bwd_kernel):
  dq over the forward plan (the same row walk, on its own work list) and
  the per-lane planes dk_lane and dv_lane, where lane (b, j) sums the set
  bits of column j of block b. `attention_bwd_summed` runs K10 with the
  planes summed into source rows by hind in a fixed order: the lanes that
  hold bits, grouped by hind (`lane_source_order`), summed in lane order
  within a source, with no atomics. `scatter_lanes` is the plain version's
  sum (index_add_).
- `spmm_attention_ad` is K9's op with its gradient: forward K9; backward K11
  and K12 when given the transpose plan, else `attention_bwd_summed`.

K9-K12 are the registered ops ``torch.ops.voltrix.spmm_attention``,
``attention_bwd``, ``attention_dq`` and ``attention_dkv`` (ops/library.py),
which every call goes through; K9's op carries `spmm_attention_ad`'s
gradient. An op's body runs the plain versions on a CPU tensor: they
take the edges from the bitmask, compute scores by gather, the row
maxima and denominators by segment reductions, and aggregate with
`index_add_`. On a CUDA tensor it launches the kernel or raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from ..format.plan import SpmmPlan
from ..utils import kept_beside
from ._attn_core import (
    _EMPTY_LSE,
    BF16_BACKWARD,
    IMPLS,
    _act,
    _check_bwd,
    _check_plan,
    _check_qkv,
    _dkv_plain,
    _dq_plain,
    _ds,
    _edge_chunks,
    _edges,
    _fwd_plain,
    _loader,
    _on_cuda,
    _refuse_knobs,
    _tensors,
    _vec4,
    compute_bf16,
    op_compute_dtype,
)
from .block_spmm import (
    _INT_MAX,
    PIECE_BLOCKS,
    PIECE_WORK,
    acc_width,
    launch,
    plan_walk,
    walk_stats,
)
from .reference import CHUNK_BYTES

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the plan's arrays and the work list, the kernel's tensors, then the geometry
load_fwd_library = _loader("attn_fwd", "voltrix_attn_fwd",
                           [_p] * 11 + [_i] * 10 + [_f, _f, _i, _i, _p])
load_bwd_library = _loader("attn_bwd", "voltrix_attn_bwd",
                           [_p] * 20 + [_i] * 11 + [_f, _f, _i, _i, _p])
# K13 (ops/attention_mh.py) from the same library as K9: the plan's arrays
# and the work list, the tensors, then the geometry, the plane, the
# alignment flags and the (head, row) strides of q, k and v
load_mh_fwd_library = _loader("attn_fwd", "voltrix_attn_mh_fwd",
                              [_p] * 11 + [_i] * 14 + [_f, _f, _i, _i, _i]
                              + [ctypes.c_longlong] * 6 + [_p])
# the kernels whose cut groups keep each piece's (m, l, acc) share
SHARE_KERNELS = ("spmm_attention", "spmm_attention_mh")


# --- the work list of K9-K15 ---------------------------------------------------------

def attention_walk(plan: SpmmPlan, name: str):
    """K9's (name "spmm_attention"), K13's ("spmm_attention_mh"), K10's
    ("attention_bwd"), K14's ("attention_mh_dq"), K15's ("attention_mh_dkv",
    on a transpose plan), K11's ("attention_dq") or K12's ("attention_dkv")
    work list of `plan`: ops/block_spmm.py's `plan_walk` at the kernel's
    PIECE_BLOCKS and PIECE_WORK, kept under the kernel's own name. K10-K12,
    K14 and K15 add a cut group's pieces 1.. into workspace tiles (the
    walk's layout; K14 and K15 launch it as ops/_attn_core.py's `plan_walk`
    call); K9 and K13 keep
    every piece's (m, l, acc) share of a cut group, so their slots are
    renumbered: piece p of a group whose first slot is s takes slot s + p,
    and the merges' first slots move likewise. Built once per plan and kept
    beside its block_ptr (`utils.kept_beside`)."""
    walk = plan_walk(plan, name)
    if name not in SHARE_KERNELS:
        return walk

    def build():
        merges = walk.merges.long()
        tasks = walk.tasks.long().clone()
        cut = tasks[:, 5] >= 0
        # the group's place among the cut groups: one more slot before it each
        tasks[cut, 5] += torch.searchsorted(merges[:, 2].contiguous(), tasks[cut, 5])
        merges[:, 2] += torch.arange(len(merges), device=merges.device)
        return dataclasses.replace(walk, tasks=tasks.int(), merges=merges.int(),
                                   slots=walk.slots + len(merges))

    key = ("shares", name, PIECE_BLOCKS[name], PIECE_WORK[name], plan.config.words_per_col,
           plan.source_rows)
    return kept_beside(plan.block_ptr, key, build, plan.bitmask, plan.hind, plan.occ)


def attention_walk_stats(plan: SpmmPlan, name: str, d: int, heads: int = 1) -> dict:
    """`walk_stats` of a work list of `attention_walk` at width d, with
    the kernel's own workspace: K9 and K13 keep m, l and d columns a row
    (and a head) of every piece of a cut group, K10-K12, K14 and K15 d
    columns of its pieces 1.. (K14: d = dk; K15: d = dk + dv, its two
    workspaces) (MiB)."""
    walk = attention_walk(plan, name)
    stats = walk_stats(plan, walk, d)
    width = d + 2 if name in SHARE_KERNELS else d
    stats["workspace_mib"] = walk.slots * heads * walk.rows * width * 4 / 2**20
    return stats


# --- K10's source order --------------------------------------------------------------

@dataclass
class LaneSources:
    """K10's source order of a plan (`lane_source_order`), on its device."""

    lane: torch.Tensor  # int32 (n,) the flat lanes b * block_w + j that hold a bit, ascending
    lane_slot: torch.Tensor  # int32 (total_blocks * block_w,) a lane's slot, -1 without bits
    slot_lane: torch.Tensor  # int32 (n,) the lane of each slot
    offsets: torch.Tensor  # int32 (source_rows + 1,) source s's slots offsets[s] .. offsets[s + 1]


def lane_source_order(plan: SpmmPlan) -> LaneSources:
    """The plan's lanes that hold a bit, each once, and their order by
    source: the lanes whose hind lies in [0, source_rows) grouped by hind,
    in lane order within a source (source s's slots are offsets[s] ..
    offsets[s + 1]), then the lanes whose hind lies outside, which the sum
    drops, as segment_sum drops them. Plain torch on the plan's device; the
    sizes cost a host sync, once per plan (`plan_lane_sources`)."""
    k, nk = plan.config.block_w, plan.source_rows
    if plan.total_blocks * k > _INT_MAX:
        raise ValueError("K10's source order indexes lanes with 32-bit ints")
    lane = torch.nonzero((plan.bitmask != 0).any(1).reshape(-1)).squeeze(1)
    hind = plan.hind.reshape(-1)[lane].long()
    key = torch.where((hind >= 0) & (hind < nk), hind, nk)
    _, order = torch.sort(key, stable=True)
    lane_slot = torch.full((plan.total_blocks * k,), -1, dtype=torch.int32, device=lane.device)
    lane_slot[lane[order]] = torch.arange(len(order), dtype=torch.int32, device=lane.device)
    offsets = torch.zeros(nk + 1, dtype=torch.int64, device=lane.device)
    torch.cumsum(torch.bincount(key, minlength=nk + 1)[:nk], 0, out=offsets[1:])
    return LaneSources(lane=lane.int(), lane_slot=lane_slot, slot_lane=lane[order].int(),
                       offsets=offsets.int())


def plan_lane_sources(plan: SpmmPlan) -> LaneSources:
    """`lane_source_order(plan)`, built at its first use and kept beside
    the plan's hind tensor (checked against its bitmask)."""
    key = ("lane_sources", plan.source_rows, plan.config.block_w)
    return kept_beside(plan.hind, key, lambda: lane_source_order(plan), plan.bitmask)


def sum_slots_reference(sources: LaneSources, slots: torch.Tensor,
                        num_rows: int) -> torch.Tensor:
    """The plain version of K10's sum: (num_rows, d) rows, row s the sum of
    `slots` (a plane in the source order) over s's slots, in order
    (`torch.segment_reduce`); slots past the in-range sources are dropped."""
    offsets = sources.offsets.long()
    if offsets.numel() != num_rows + 1:
        raise ValueError(f"sum_slots_reference: the order has {offsets.numel() - 1} source rows, "
                         f"not {num_rows}")
    kept = slots[:int(offsets[-1])]
    if kept.shape[0] == 0:
        return slots.new_zeros(num_rows, slots.shape[1])
    return torch.segment_reduce(kept, "sum", offsets=offsets, unsafe=True)


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
                             out_dtype=None, compute_dtype=None,
                             chunk_bytes: int = CHUNK_BYTES):
    """The plain version of K9: out (num_nodes, dv) in `out_dtype` (default
    v's) and, with return_stats, lse (padded_nodes,) float32;
    compute_dtype=torch.bfloat16 rounds at the JAX package's points
    (ops/_attn_core.py:_fwd_plain_bf16)."""
    spmm_attention_reference.calls += 1
    compute = compute_bf16(compute_dtype)
    dk = _check_single(plan, q, k, v, "spmm_attention_reference")[2]
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out, lse = _fwd_plain(plan, q[None], k[None], v[None], scale, negative_slope, None,
                          chunk_bytes, compute)
    out = out[0].to(v.dtype if out_dtype is None else out_dtype)
    return (out, lse[0]) if return_stats else out


spmm_attention_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def spmm_attention(plan: SpmmPlan, q, k, v, *, scale: float | None = None,
                   negative_slope: float = 1.0, block_d=None, compute_dtype=None,
                   precision=None, return_stats: bool = False, interpret=None, out_dtype=None):
    """Fused attention aggregation of one head through kernel K9
    (csrc/attn_fwd.cu), as the registered op
    ``torch.ops.voltrix.spmm_attention`` (ops/library.py): out[r] = softmax
    over r's in-neighbours l of act(scale q[r] . k[l]), applied to v. q
    (num_nodes, dk), k (source_rows, dk), v (source_rows, dv); returns
    (num_nodes, dv) in `out_dtype` (default v's) and, with return_stats,
    lse (padded_nodes,) float32. scale defaults to 1/sqrt(dk);
    negative_slope 1.0 is the identity. compute_dtype=torch.bfloat16 rounds
    q, k, v and p to bf16 before their products, as the JAX package does
    (K13's bf16 kernel at one head, csrc/attn_fwd_bf16.cu; counted in
    `launches` and `launches_bf16`); its inputs may not need a gradient
    (NotImplementedError). A plan with a value plane raises ValueError; the
    TPU knobs block_d, precision and interpret raise NotImplementedError."""
    from . import library

    _refuse_knobs(compute_dtype, precision, block_d, interpret)
    nq, _, dk, dv = _check_single(plan, q, k, v, "spmm_attention")
    _on_cuda(q, "spmm_attention")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else scale
    out_dtype = v.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        out = torch.zeros(nq, dv, dtype=out_dtype, device=q.device)
        if return_stats:
            return out, torch.full((plan.padded_nodes,), _EMPTY_LSE, dtype=torch.float32,
                                   device=q.device)
        return out
    out, lse = library.call_attention(plan, q, k, v, float(scale), float(negative_slope),
                                      compute_dtype=op_compute_dtype(compute_dtype))
    out = out.to(out_dtype)
    return (out, lse) if return_stats else out


spmm_attention.launches = 0  # plain-int launch count, read by chip_smoke.py
# of which at compute_dtype=bfloat16 (csrc/attn_fwd_bf16.cu)
spmm_attention.launches_bf16 = 0


def _fwd_kernel(plan: SpmmPlan, walk, q, k, v, scale: float, slope: float):
    """out (num_nodes, dv) and lse (padded_nodes,), float32, through K9,
    the op's body (ops/library.py): the walk over `walk`
    (`attention_walk(plan, "spmm_attention")`) and, when a group is cut,
    the merge of its shares. Every row is written."""
    name = "spmm_attention"
    dev = q.device
    f32 = torch.float32
    qc, kc, vc = _tensors(name, dev, (q, f32), (k, f32), (v, f32))
    (nq, dk), (nk, dv) = qc.shape, vc.shape
    cfg = plan.config
    out = torch.empty(nq, dv, dtype=f32, device=dev)
    lse = torch.empty(plan.padded_nodes, dtype=f32, device=dev)
    if dv == 0 or plan.total_blocks == 0:
        return out.zero_(), lse.fill_(_EMPTY_LSE)
    acc = acc_width(dv)
    if walk.tasks.shape[0] > _INT_MAX or -(-dv // acc) > 65535:
        raise ValueError(f"{name}: more tasks or columns than the grid takes")
    ws_ml = ws_acc = None
    if walk.slots:
        ws_ml = torch.empty(walk.slots * walk.rows * 2, dtype=f32, device=dev)
        ws_acc = torch.empty(walk.slots * walk.rows * dv, dtype=f32, device=dev)
    launch(
        name, load_fwd_library(), q, plan.bitmask.data_ptr(), plan.hind.data_ptr(),
        walk.tasks.data_ptr(), walk.merges.data_ptr(), qc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), out.data_ptr(), lse.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(), None if ws_acc is None else ws_acc.data_ptr(),
        walk.tasks.shape[0], walk.merges.shape[0], cfg.words_per_col, cfg.block_h, cfg.block_w,
        nq, nk, dk, dv, acc, float(scale), float(slope), _vec4(dk, qc, kc), _vec4(dv, vc, out),
    )
    spmm_attention.launches += 1
    return out, lse


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
    1) over `plan`, as the registered op ``torch.ops.voltrix.attention_dq``
    (ops/library.py, on H = 1 views); see the plain version."""
    from . import library

    _on_cuda(q, "attention_dq")
    views = _one_head("attention_dq", q, k, v, g, lse, d_row)
    _check_bwd(plan, *views, "attention_dq", False)
    return library.call_attention_dq("attention_dq", plan, *views, float(scale),
                                float(negative_slope), None)[0]


attention_dq.launches = 0  # plain-int launch count, read by chip_smoke.py


def attention_dkv(plan_t: SpmmPlan, q, k, v, g, lse, d_row, *, scale: float,
                  negative_slope: float = 1.0):
    """(dk, dv) float32 through kernel K12 (K15's kernel at H = 1) over the
    transpose plan, as the registered op ``torch.ops.voltrix.attention_dkv``
    (ops/library.py, on H = 1 views); see the plain version."""
    from . import library

    _on_cuda(q, "attention_dkv")
    views = _one_head("attention_dkv", q, k, v, g, lse, d_row)
    _check_bwd(plan_t, *views, "attention_dkv", True)
    dk, dv = library.call_attention_dkv("attention_dkv", plan_t, *views, float(scale),
                                   float(negative_slope), None)
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
    """(dq, dk_lane, dv_lane) float32 through kernel K10 (csrc/attn_bwd.cu),
    as the registered op ``torch.ops.voltrix.attention_bwd``
    (ops/library.py); see the plain version. K10 writes the lanes that
    hold bits in the source order (`plan_lane_sources`); their rows go to
    their lanes of planes that are zero elsewhere. D = rowsum(dO o out) is
    one PyTorch reduction before the launch."""
    from . import library

    _on_cuda(q, "attention_bwd")
    _check_lanes(plan, q, k, v, out, lse, g, "attention_bwd")
    return library.call_attention_bwd(plan, q, k, v, out, lse, g, float(scale),
                                 float(negative_slope), False)


attention_bwd.launches = 0  # plain-int launch count, read by chip_smoke.py


def attention_bwd_summed(plan: SpmmPlan, q, k, v, out, lse, g, *, scale: float,
                         negative_slope: float = 1.0):
    """(dq, dk, dv) float32: K10 with its lane planes summed into source
    rows by hind in a fixed order, with no atomics (what `segment_sum`
    gives in the JAX package's _attn_bwd), as the registered op
    ``torch.ops.voltrix.attention_bwd``. A CUDA tensor launches K10 once
    (csrc/attn_bwd.cu: its dq walk, its lane pass into the source order of
    `plan_lane_sources`, and its sum, a warp per source row adding its
    slots in order); a CPU tensor runs the plain version of K10, takes its
    lane planes in the same order and sums them with
    `sum_slots_reference`."""
    from . import library

    _on_cuda(q, "attention_bwd")
    _check_lanes(plan, q, k, v, out, lse, g, "attention_bwd")
    return library.call_attention_bwd(plan, q, k, v, out, lse, g, float(scale),
                                 float(negative_slope), True)


def bwd_plain(plan: SpmmPlan, sources: LaneSources, q, k, v, out, lse, g, scale: float,
              slope: float, summed: bool):
    """The op's body on the CPU (ops/library.py): the plain version of K10,
    with `summed` its lane planes taken in the source order `sources` and
    summed with `sum_slots_reference`."""
    dq, dk_lane, dv_lane = attention_bwd_reference(plan, q, k, v, out, lse, g, scale=scale,
                                                   negative_slope=slope)
    if not summed:
        return dq, dk_lane, dv_lane
    idx = sources.slot_lane.long()
    return (dq, *(sum_slots_reference(sources, t.index_select(0, idx), k.shape[0])
                  for t in (dk_lane, dv_lane)))


def _bwd_kernel(plan: SpmmPlan, walk, sources: LaneSources, q, k, v, out, lse, g, scale: float,
                slope: float, summed: bool):
    """K10 on the card, the op's body (ops/library.py): dq and either the
    lane planes (the lanes' rows in the source order `sources`, copied to
    their lanes of zero planes) or, `summed`, dk and dv (source_rows rows).
    Counts one launch of attention_bwd."""
    name = "attention_bwd"
    nq, dk = q.shape
    nk, dv = v.shape
    dev = q.device
    f32 = torch.float32
    qc, kc, vc, gc, lc = _tensors(name, dev, (q, f32), (k, f32), (v, f32), (g, f32), (lse, f32))
    d_row = (gc * out.float()).sum(-1)
    cfg = plan.config
    n = sources.lane.shape[0]
    lanes = plan.total_blocks * cfg.block_w
    if plan.total_blocks == 0 or dk + dv == 0:
        sides = (torch.zeros(nk if summed else lanes, d, dtype=f32, device=dev) for d in (dk, dv))
        return torch.zeros(nq, dk, dtype=f32, device=dev), *sides
    acc = acc_width(max(dk, dv))
    if walk.tasks.shape[0] > _INT_MAX or -(-max(dk, dv) // acc) > 65535:
        raise ValueError(f"{name}: more tasks or columns than the grid takes")
    dq = torch.empty(nq, dk, dtype=f32, device=dev)
    ws = (torch.empty(walk.slots * walk.rows * dk, dtype=f32, device=dev)
          if walk.slots and dk else None)
    slot_k = torch.empty(n, dk, dtype=f32, device=dev)
    slot_v = torch.empty(n, dv, dtype=f32, device=dev)
    dk_out = torch.empty(nk, dk, dtype=f32, device=dev) if summed else None
    dv_out = torch.empty(nk, dv, dtype=f32, device=dev) if summed else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch(
        name, load_bwd_library(), q, plan.bitmask.data_ptr(), plan.hind.data_ptr(),
        plan.window_of_block.data_ptr(), walk.tasks.data_ptr(), walk.merges.data_ptr(),
        sources.lane.data_ptr(), sources.lane_slot.data_ptr(),
        sources.offsets.data_ptr() if summed else None, qc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), gc.data_ptr(), lc.data_ptr(), d_row.data_ptr(), dq.data_ptr(), ptr(ws),
        slot_k.data_ptr(), slot_v.data_ptr(), ptr(dk_out), ptr(dv_out), walk.tasks.shape[0],
        walk.merges.shape[0], n, cfg.words_per_col, cfg.block_h, cfg.block_w, nq, nk, dk, dv,
        acc, float(scale), float(slope), _vec4(dk, qc, kc), _vec4(dv, vc, gc),
    )
    attention_bwd.launches += 1
    if summed:
        return dq, dk_out, dv_out
    idx = sources.slot_lane.long()
    return dq, *(torch.zeros(lanes, t.shape[1], dtype=f32, device=dev).index_copy_(0, idx, t)
                 for t in (slot_k, slot_v))


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

class _PlainAttention(torch.autograd.Function):
    """`spmm_attention_ad(impl="reference")`: the plain versions of K9-K12
    with the kernels' gradient (without plan_t, K10's plain lane planes
    summed by `scatter_lanes`)."""

    @staticmethod
    def forward(ctx, q, k, v, plan, plan_t, scale, slope):
        ctx.plan, ctx.plan_t, ctx.scale, ctx.slope = plan, plan_t, scale, slope
        out, lse = spmm_attention_reference(plan, q, k, v, scale=scale, negative_slope=slope,
                                            return_stats=True)
        # residuals are O(n): the inputs, out and lse; no per-edge tensor
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.float().contiguous()
        kw = dict(scale=ctx.scale, negative_slope=ctx.slope)
        dq = dk = dv = None
        if ctx.plan_t is None:
            dq, dk_lane, dv_lane = attention_bwd_reference(ctx.plan, q, k, v, out, lse, g, **kw)
            dk = scatter_lanes(ctx.plan, dk_lane, k.shape[0])
            dv = scatter_lanes(ctx.plan, dv_lane, v.shape[0])
        else:
            d_row = (g * out.float()).sum(-1)  # D = rowsum(dO o out), float32
            if ctx.needs_input_grad[0]:
                dq = attention_dq_reference(ctx.plan, q, k, v, g, lse, d_row, **kw)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                dk, dv = attention_dkv_reference(ctx.plan_t, q, k, v, g, lse, d_row, **kw)
        grads = [t if t is None else t.to(x.dtype) for t, x in ((dq, q), (dk, k), (dv, v))]
        return (*grads, None, None, None, None)


def spmm_attention_ad(plan: SpmmPlan, q, k, v, *, plan_t: SpmmPlan | None = None,
                      scale: float | None = None, negative_slope: float = 1.0,
                      compute_dtype=None, precision=None, impl: str = "auto"):
    """Differentiable fused attention of one head (gradients for q, k and
    v): the registered op ``torch.ops.voltrix.spmm_attention``
    (ops/library.py) and its gradient; exactly `spmm_attention` forward
    (K9), saving out and lse, never a per-edge tensor. With plan_t
    (csr_preprocess of A^T; the same object for a symmetric graph) the
    backward is split: K11 over `plan` for dq and K12 over `plan_t` for dk
    and dv. Without it, K10 emits dq and sums its per-lane dk and dv planes
    by hind in a fixed order (`attention_bwd_summed`); impl="reference"
    sums the plain version's planes with `scatter_lanes`. impl: "auto"
    (the kernels on the card, the plain versions on the CPU) or
    "reference" (the plain versions). compute_dtype=torch.bfloat16 runs the
    forward alone: inputs that need a gradient raise NotImplementedError
    before any launch (the backward's compute_dtype is ROADMAP.md item
    9)."""
    from . import library

    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: it takes {', '.join(IMPLS)}")
    _refuse_knobs(compute_dtype, precision)
    compute = op_compute_dtype(compute_dtype)
    dk = _check_single(plan, q, k, v, "spmm_attention_ad")[2]
    _on_cuda(q, "spmm_attention_ad")
    if plan_t is not None:
        _check_plan(plan_t, "spmm_attention_ad")
        if (plan_t.num_nodes, plan_t.source_rows) != (plan.source_rows, plan.num_nodes):
            raise ValueError("plan_t must be the transpose of plan (its rows are plan's "
                             "source rows and its columns plan's rows)")
    scale = 1.0 / float(dk) ** 0.5 if scale is None else float(scale)
    if compute == torch.bfloat16:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(BF16_BACKWARD)
        if impl == "reference":
            return spmm_attention_reference(plan, q, k, v, scale=scale,
                                            negative_slope=negative_slope, compute_dtype=compute)
    if impl == "reference":
        return _PlainAttention.apply(q, k, v, plan, plan_t, scale, float(negative_slope))
    return library.call_attention(plan, q, k, v, scale, float(negative_slope), plan_t=plan_t,
                                  differentiable=True, compute_dtype=compute)[0]

"""The ELL SpMM and SDDMM: kernels K6 and K7, their wrappers, plain
versions and gradients (counterpart of voltrix_spmm_tpu/ops/ell.py).

On an `EllPlan` (format/ell.py; one lane per edge):

- `spmm_ell(plan, feat)` computes out = (A o V) @ feat through K6
  (csrc/spmm_ell.cu, replacing ell.py:_ell_fwd_kernel), on float32,
  bfloat16 or float16 rows (widened exactly in the kernel);
  compute_dtype=bfloat16 or float16 rounds float32 rows and the edge values
  to it first, as JAX's kernel does (ell.py:56-59). Padding lanes
  (erow = -1) add nothing, whatever `vals` holds there. K6 walks the
  plan's row order (`ell_row_order`: lanes grouped by destination row,
  rows cut into pieces of at most PIECE_LANES lanes), built at a plan's
  first launch and kept while its erow tensor lives (`plan_rows`), and
  sums each row in a fixed order: two launches give the same bits.
- `spmm_ell_dvals(plan, feat, g)` computes the lane gradient
  dval[b, l] = g[wob[b] * block_h + erow[b, l]] . feat[hind[b, l]] through
  K7 (csrc/spmm_ell_dvals.cu, replacing ell.py:_ell_dvals_kernel), exactly
  0.0 on padding lanes; with g = x and feat = y it is the SDDMM. Rows of at
  least DVALS_WIDE_MIN_D floats take K7's wide kernel (`_k7_wide`), which
  walks the plan's lanes grouped by source row (`ell_source_order`, cut
  into pieces of at most DVALS_PIECE_LANES lanes of one window, built at a
  plan's first launch and kept while its erow tensor lives:
  `plan_sources`); narrower rows take the sub-group kernel.
- `spmm_ell_ad`, `sddmm_ell` and `sddmm_ell_ad` are built on the two.

K6 and K7 are the registered ops ``torch.ops.voltrix.spmm_ell`` and
``spmm_ell_dvals`` (ops/library.py), which every call goes through: the
wrappers check their arguments and call the op, whose body runs the
plain versions, `spmm_ell_reference` and `spmm_ell_dvals_reference`, on a
CPU tensor, and on a CUDA tensor launches the kernel (`k6_kernel`,
`k7_kernel`) over the orders kept among the op's operands, or raises:
there is no fallback. K6's op carries `spmm_ell_ad`'s gradient, K7's
`sddmm_ell_ad`'s; `edge_values` and `lane_values` stay gathers outside
the ops.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..format.ell import EllPlan, edge_values, lane_values, slice_ell_windows
from ..jit import build
from ..utils import kept_beside
from .block_spmm import (_INT_MAX, FEAT_DTYPES, HALF_DTYPES, cast_out, count_launch,
                         half_compute, launch)
from .reference import CHUNK_BYTES
from .weighted import _check_kernel_args

# the most lanes of one row a K6 warp sums (`ell_row_order`):
# python3 -m voltrix_spmm_tpu_torch.tools.k6_piece_sweep (paths E and F)
PIECE_LANES = 512
# K7's wide kernel: the narrowest rows it takes, and the most lanes of one
# window a thread block of it walks (`ell_source_order`):
# python3 -m voltrix_spmm_tpu_torch.tools.k7_sweep (paths E and F)
DVALS_WIDE_MIN_D = 128
DVALS_PIECE_LANES = 8192
# the wide kernel holds a window's g rows in shared memory (bytes), and a
# lane's feat row in at most 4 float4 a thread (csrc/spmm_ell_dvals.cu)
_WIDE_SMEM = 192 * 1024
_WIDE_MAX_D = 512
IMPLS = ("auto", "ell", "reference")


@functools.cache
def load_library():
    """Build (or reuse) K6's library; return (launch, error_string)."""
    rt = build("spmm_ell", ["spmm_ell.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_ell_f32", [p] * 8 + [i] * 6 + [p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


@functools.cache
def load_bf16_library():
    """K6's bf16 instantiation from the same build; return (launch,
    error_string)."""
    rt = build("spmm_ell", ["spmm_ell.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    return rt.function("voltrix_spmm_ell_bf16", [p] * 8 + [i] * 7 + [p]), load_library()[1]


@functools.cache
def load_f16_library():
    """K6's float16 instantiation from the same build; return (launch,
    error_string)."""
    rt = build("spmm_ell", ["spmm_ell.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    return rt.function("voltrix_spmm_ell_f16", [p] * 8 + [i] * 7 + [p]), load_library()[1]


@functools.cache
def load_dvals_library():
    """Build (or reuse) K7's library; return (launch, wide_launch,
    error_string): its sub-group kernel, its wide kernel and CUDA's error
    message."""
    rt = build("spmm_ell_dvals", ["spmm_ell_dvals.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_ell_dvals_f32",
                     [p, p, p, p, p, p, ctypes.c_int64, i, i, i, i, i, i, i, p])
    wide = rt.function("voltrix_spmm_ell_dvals_wide_f32", [p] * 7 + [i] * 4 + [p])
    return fn, wide, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


def _check_rows(plan: EllPlan, feat: torch.Tensor, name: str) -> None:
    if not isinstance(plan, EllPlan):
        raise TypeError(f"{name} takes an EllPlan (csr_preprocess_ell), got {type(plan).__name__}")
    if feat.dim() != 2 or feat.shape[0] != plan.source_rows:
        raise ValueError(
            f"{name}: feat must be (source_rows={plan.source_rows}, D), got {tuple(feat.shape)}"
        )


def _check_g(plan: EllPlan, feat: torch.Tensor, g: torch.Tensor, name: str) -> None:
    _check_rows(plan, feat, name)
    if g.dim() != 2 or tuple(g.shape) != (plan.num_nodes, feat.shape[1]):
        raise ValueError(
            f"{name}: g must be (num_nodes={plan.num_nodes}, {feat.shape[1]}), "
            f"got {tuple(g.shape)}"
        )


def _lane_chunks(plan: EllPlan, d: int, chunk_bytes: int):
    """(l0, l1, kept lanes, their output rows, their source rows) over the
    plan's lanes in chunks of about `chunk_bytes` of gathered rows; kept
    lanes are the real ones (erow >= 0, row < num_nodes)."""
    K, H = plan.config.block_w, plan.config.block_h
    hind = plan.hind.reshape(-1)
    erow = plan.erow.reshape(-1)
    wob = plan.window_of_block.long()
    src_max = plan.source_rows - 1
    step = max(K, chunk_bytes // (8 * max(d, 1) + 32))
    for l0 in range(0, plan.gather_rows, step):
        l1 = min(plan.gather_rows, l0 + step)
        lanes = torch.arange(l0, l1, device=hind.device)
        e = erow[l0:l1].long()
        rows = wob[lanes // K] * H + e
        keep = (e >= 0) & (rows < plan.num_nodes)
        src = hind[l0:l1].long().clamp(0, src_max)
        yield l0, l1, keep, rows[keep], src[keep]


def spmm_ell_reference(plan: EllPlan, feat: torch.Tensor, out_dtype=None, *,
                       chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """out = (A o V) @ feat over the plan's lanes, accumulated in float32:
    gather, scale by `vals`, `index_add_` into wob * block_h + erow over
    the lanes with erow >= 0. The plain version of K6; walks the lanes in
    chunks of about `chunk_bytes`."""
    spmm_ell_reference.calls += 1
    _check_rows(plan, feat, "spmm_ell_reference")
    d = feat.shape[1]
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    out = torch.zeros(plan.num_nodes, d, dtype=torch.float32, device=feat.device)
    vals = plan.vals.reshape(-1)
    for l0, l1, keep, rows, src in _lane_chunks(plan, d, chunk_bytes):
        contrib = feat.index_select(0, src).float() * vals[l0:l1][keep].float()[:, None]
        out.index_add_(0, rows, contrib)
    return out.to(out_dtype)


spmm_ell_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def _k6_lanes(d: int, aligned: bool) -> tuple[int, int, int]:
    """K6's (vec, tpe, unroll): four columns a load (a float4, or 8 bytes
    of bf16) when d % 4 == 0 and feat is `aligned` to that load; tpe threads an edge, the power of two (at most 32) at
    or above the row's vectors, so a warp has 32 / tpe edge slots; each
    thread gathers `unroll` edges at a time, so that a warp keeps about 8
    edges in flight (4 a thread at most)."""
    vec = 4 if aligned and d % 4 == 0 else 1
    tpe = 1
    while tpe < -(-d // vec) and tpe < 32:
        tpe *= 2
    return vec, tpe, max(1, min(4, 8 * tpe // 32))


@dataclass
class EllRows:
    """K6's row order of a plan (`ell_row_order`), on the plan's device."""

    src: torch.Tensor  # int32 (kept lanes,) source row, clipped, in row order
    lane: torch.Tensor  # int32 (kept lanes,) flat lane index (for vals)
    items: torch.Tensor  # int32 (items, 4): row, first, end, workspace row or -1
    merges: torch.Tensor  # int32 (cut rows, 3): row, workspace row of piece 1, pieces
    slots: int  # workspace rows
    piece_lanes: int


def ell_row_order(plan: EllPlan, piece_lanes: int) -> EllRows:
    """The plan's non-padding lanes (erow >= 0, row < num_nodes) grouped by
    destination row, in lane order within a row, with each lane's source
    row clipped into the source rows (jnp.take(mode="clip")); each row cut
    into pieces (items) of at most `piece_lanes` lanes, an empty row into
    one empty piece; a cut row's pieces 1.. each get a workspace row. A
    row's pieces depend on its own lanes alone, so a window chunk of the
    plan (`slice_ell_windows`) cuts its rows as the whole plan does. Plain
    torch on the plan's device; the sizes cost a few host syncs, once per
    plan (`plan_rows`)."""
    if piece_lanes < 1:
        raise ValueError(f"piece_lanes must be >= 1, got {piece_lanes}")
    if max(plan.num_nodes, plan.gather_rows) > _INT_MAX:
        raise ValueError("K6's row order indexes rows and lanes with 32-bit ints")
    K, H, n = plan.config.block_w, plan.config.block_h, plan.num_nodes
    dev = plan.erow.device
    e = plan.erow.reshape(-1).long()
    rows = plan.window_of_block.long().repeat_interleave(K) * H + e
    lane = torch.nonzero((e >= 0) & (rows < n)).squeeze(1)
    rows, order = torch.sort(rows[lane], stable=True)
    lane = lane[order]
    src = plan.hind.reshape(-1)[lane].clamp(0, plan.source_rows - 1)
    counts = torch.bincount(rows, minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=ptr[1:])
    pieces = ((counts + piece_lanes - 1) // piece_lanes).clamp(min=1)
    item_row = torch.repeat_interleave(torch.arange(n, device=dev), pieces)
    rank = torch.arange(len(item_row), device=dev) - (pieces.cumsum(0) - pieces)[item_row]
    first = ptr[item_row] + rank * piece_lanes
    end = torch.minimum(first + piece_lanes, ptr[item_row + 1])
    extra = pieces - 1
    slot0 = extra.cumsum(0) - extra  # a cut row's first workspace row
    slot = torch.where(rank == 0, -1, slot0[item_row] + rank - 1)
    cut = torch.nonzero(extra).squeeze(1)
    return EllRows(
        src=src.int(), lane=lane.int(),
        items=torch.stack([item_row, first, end, slot], 1).int(),
        merges=torch.stack([cut, slot0[cut], pieces[cut]], 1).int(),
        slots=int(extra.sum()), piece_lanes=piece_lanes)


def plan_rows(plan: EllPlan) -> EllRows:
    """K6's row order of `plan` at PIECE_LANES, built at its first launch and
    kept beside the plan's erow tensor (`utils.kept_beside`, checked against
    its hind and window_of_block tensors) until that tensor is freed: plans
    made by dataclasses.replace(plan, vals=...) (a new lane plane each call
    in GATDot, spmm_ell_ad and sddmm_ell_ad's backward) share it."""
    key = ("rows", plan.num_nodes, plan.source_rows, plan.config.block_h, PIECE_LANES)
    return kept_beside(plan.erow, key, lambda: ell_row_order(plan, PIECE_LANES), plan.hind,
                       plan.window_of_block)


def spmm_ell(plan: EllPlan, feat: torch.Tensor, out_dtype=None, *,
             compute_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = (A o V) @ feat through kernel K6 (float32, bf16
    or float16 in, float32 accumulation in a fixed order, cast to
    `out_dtype`, default feat's dtype, at the end), as the registered op
    ``torch.ops.voltrix.spmm_ell`` (ops/library.py).
    compute_dtype=torch.bfloat16 or torch.float16 rounds the features
    (round to nearest even) and, in the kernel, the edge values to it
    first, the JAX kernel's compute_dtype; the output then defaults to the
    caller's feature dtype."""
    from . import library

    compute = half_compute(compute_dtype)
    round_vals = compute is not None
    if round_vals:
        out_dtype = feat.dtype if out_dtype is None else out_dtype
        feat = feat.to(compute)
    _check_ell(plan, feat, "spmm_ell")
    out = library.call_ell(plan, feat, round_vals=round_vals)
    return cast_out(out, feat.dtype if out_dtype is None else out_dtype)


def _check_ell(plan: EllPlan, feat: torch.Tensor, name: str) -> None:
    """What K6 takes: an EllPlan, the features' rows, and on the card
    contiguous float32, bf16 or float16 features and int32 lanes on their
    device."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {feat.device}")
    _check_rows(plan, feat, name)
    if feat.device.type == "cuda":
        tb, K = plan.total_blocks, plan.config.block_w
        _check_kernel_args(plan, name, {
            "hind": (torch.int32, (tb, K)),
            "erow": (torch.int32, (tb, K)),
            "vals": (torch.float32, (tb, K)),
            "window_of_block": (torch.int32, (tb,)),
        }, feat, dtypes=FEAT_DTYPES)


def k6_kernel(plan: EllPlan, rows: EllRows, feat: torch.Tensor, round_vals: bool) -> torch.Tensor:
    """K6 on the card over the plan's row order `rows`, the op's body
    (ops/library.py): float32 (num_nodes, d); with round_vals the 16-bit
    instantiation rounds the edge values to the features' type."""
    d = feat.shape[1]
    half = feat.dtype in HALF_DTYPES
    if half and feat.data_ptr() % 8:
        # 8-byte loads of four 16-bit values need 8-byte aligned rows: a
        # misaligned view is copied once (a fresh tensor is aligned), so
        # every 16-bit input walks with the lanes of the float32 kernel on
        # its widened rows, and sums in its order
        feat = feat.clone()
    vec, tpe, unroll = _k6_lanes(d, feat.data_ptr() % (4 * feat.element_size()) == 0)
    if -(-d // (tpe * vec)) > 65535:
        raise ValueError("D exceeds spmm_ell's grid limits")
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=feat.device)
    if out.numel():
        ws = None
        if rows.slots:
            ws = torch.empty(rows.slots * d, dtype=torch.float32, device=feat.device)
        launch(
            "spmm_ell", {torch.bfloat16: load_bf16_library, torch.float16: load_f16_library}.get(
                feat.dtype, load_library)(), feat,
            rows.items.data_ptr(), rows.src.data_ptr(), rows.lane.data_ptr(),
            plan.vals.data_ptr(), rows.merges.data_ptr(), feat.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), rows.items.shape[0], rows.merges.shape[0],
            d, vec, tpe, unroll, *((int(round_vals),) if half else ()),
        )
        count_launch(spmm_ell, feat.dtype)
    return out


spmm_ell.launches = 0  # plain-int launch count, read by chip_smoke.py
spmm_ell.launches_bf16 = 0  # of which on bf16 features (the bf16 instantiation)
spmm_ell.launches_f16 = 0  # of which on float16 features (the float16 instantiation)


def spmm_ell_streamed(plan, feat: torch.Tensor, *, num_chunks: int = 8,
                      out_dtype=None, compute_dtype=None) -> torch.Tensor:
    """K6 over window-contiguous slices of the plan, one after another, so
    only one slice's work is in flight; `plan` may be an EllPlan or the
    list `slice_ell_windows` returns."""
    subs = slice_ell_windows(plan, num_chunks) if isinstance(plan, EllPlan) else list(plan)
    outs = [spmm_ell(s, feat, out_dtype, compute_dtype=compute_dtype) for s in subs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def spmm_ell_dvals_reference(plan: EllPlan, feat: torch.Tensor, g: torch.Tensor, *,
                             chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """d/d(plan.vals) of sum(spmm_ell(plan, feat) * g): the float32
    (total_blocks, block_w) lane plane, the row-wise dot of
    g[wob * block_h + erow] and feat[hind], exactly 0.0 where erow < 0.
    The plain version of K7; walks the lanes in chunks."""
    spmm_ell_dvals_reference.calls += 1
    _check_g(plan, feat, g, "spmm_ell_dvals_reference")
    K = plan.config.block_w
    out = torch.zeros(plan.gather_rows, dtype=torch.float32, device=feat.device)
    for l0, l1, keep, rows, src in _lane_chunks(plan, feat.shape[1], chunk_bytes):
        dots = (g.index_select(0, rows).float() * feat.index_select(0, src).float()).sum(1)
        out[l0:l1][keep] = dots
    return out.view(plan.total_blocks, K)


spmm_ell_dvals_reference.calls = 0  # plain-int call count, read by chip_smoke.py


@dataclass
class EllSources:
    """K7's source order of a plan (`ell_source_order`), on its device."""

    lane: torch.Tensor  # int32 (kept lanes,) flat lane index, by window then source
    src: torch.Tensor  # int32 (kept lanes,) source row, clipped
    row: torch.Tensor  # int32 (kept lanes,) destination row in the window (erow)
    pieces: torch.Tensor  # int32 (pieces, 3): window, first, end
    piece_lanes: int


def ell_source_order(plan: EllPlan, piece_lanes: int) -> EllSources:
    """The plan's non-padding lanes (erow >= 0, row < num_nodes) grouped by
    window, then by source row (clipped into the source rows as
    jnp.take(mode="clip") does), in lane order within a source; each
    window's lanes cut into pieces of at most `piece_lanes` (a window
    without such lanes gets none). A window's pieces depend on its own
    lanes alone. Plain torch on the plan's device; the sizes cost a host
    sync, once per plan (`plan_sources`)."""
    if piece_lanes < 1:
        raise ValueError(f"piece_lanes must be >= 1, got {piece_lanes}")
    if max(plan.num_nodes, plan.gather_rows) > _INT_MAX:
        raise ValueError("K7's source order indexes rows and lanes with 32-bit ints")
    K, H, n = plan.config.block_w, plan.config.block_h, plan.num_nodes
    dev = plan.erow.device
    e = plan.erow.reshape(-1).long()
    win = plan.window_of_block.long().repeat_interleave(K)
    lane = torch.nonzero((e >= 0) & (win * H + e < n)).squeeze(1)
    src = plan.hind.reshape(-1)[lane].long().clamp(0, plan.source_rows - 1)
    win = win[lane]
    _, order = torch.sort(win * plan.source_rows + src, stable=True)
    lane, src, win = lane[order], src[order], win[order]
    counts = torch.bincount(win, minlength=plan.num_windows)
    ptr = torch.zeros(plan.num_windows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=ptr[1:])
    npieces = (counts + piece_lanes - 1) // piece_lanes
    piece_win = torch.repeat_interleave(torch.arange(plan.num_windows, device=dev), npieces)
    rank = torch.arange(len(piece_win), device=dev) - (npieces.cumsum(0) - npieces)[piece_win]
    first = ptr[piece_win] + rank * piece_lanes
    end = torch.minimum(first + piece_lanes, ptr[piece_win + 1])
    return EllSources(lane=lane.int(), src=src.int(), row=e[lane].int(),
                      pieces=torch.stack([piece_win, first, end], 1).int(),
                      piece_lanes=piece_lanes)


def plan_sources(plan: EllPlan) -> EllSources:
    """K7's source order of `plan` at DVALS_PIECE_LANES, built at its first
    wide launch and kept beside the plan's erow tensor, as `plan_rows`."""
    key = ("sources", plan.num_nodes, plan.source_rows, plan.config.block_h, DVALS_PIECE_LANES)
    return kept_beside(plan.erow, key, lambda: ell_source_order(plan, DVALS_PIECE_LANES),
                       plan.hind, plan.window_of_block)


def _k7_wide(d: int, block_h: int, aligned: bool) -> bool:
    """Whether K7 takes its wide kernel: rows of at least DVALS_WIDE_MIN_D
    and at most 512 floats, whole float4s (d % 4 == 0, feat and g 16-byte
    aligned), and a window's g rows within the kernel's shared memory."""
    return (aligned and d % 4 == 0 and DVALS_WIDE_MIN_D <= d <= _WIDE_MAX_D
            and block_h * d * 4 <= _WIDE_SMEM)


def _k7_geometry(d: int, aligned: bool) -> tuple[int, int]:
    """K7's (vec, sub): float4 loads when d % 4 == 0 and both tensors are
    16-byte aligned, and sub threads per lane, the power of two (at most
    32) at or above half the row's vectors."""
    vec = 4 if aligned and d % 4 == 0 else 1
    half = -(-(d // vec) // 2)
    sub = 1
    while sub < half and sub < 32:
        sub *= 2
    return vec, sub


def spmm_ell_dvals(plan: EllPlan, feat: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The lane gradient through kernel K7 (see the plain version for the
    definition), as the registered op ``torch.ops.voltrix.spmm_ell_dvals``
    (ops/library.py). The plan's `vals` are not read."""
    from . import library

    _check_dvals(plan, feat, g, "spmm_ell_dvals")
    return library.call_ell_dvals(plan, feat, g)


def _check_dvals(plan: EllPlan, feat: torch.Tensor, g: torch.Tensor, name: str) -> None:
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {feat.device}")
    _check_g(plan, feat, g, name)
    if feat.device.type == "cuda":
        tb, K = plan.total_blocks, plan.config.block_w
        _check_kernel_args(plan, name, {
            "hind": (torch.int32, (tb, K)),
            "erow": (torch.int32, (tb, K)),
            "window_of_block": (torch.int32, (tb,)),
        }, feat, g)


def k7_wide_rows(plan: EllPlan, d: int) -> bool:
    """Whether K7 may take its wide kernel at width d (`_k7_wide` with the
    rows aligned): the source order `plan_sources` is then among the op's
    operands."""
    return _k7_wide(d, plan.config.block_h, True)


def k7_kernel(plan: EllPlan, sources: EllSources | None, feat: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """K7 on the card, the op's body (ops/library.py): float32
    (total_blocks, block_w); the wide kernel over the source order
    `sources` where the rows qualify (given and aligned), else the
    sub-group kernel."""
    tb, H, K = plan.total_blocks, plan.config.block_h, plan.config.block_w
    d = feat.shape[1]
    if d == 0:
        return torch.zeros(tb, K, dtype=torch.float32, device=feat.device)
    aligned = feat.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    if tb and sources is not None and _k7_wide(d, H, aligned):
        out = torch.zeros(tb, K, dtype=torch.float32, device=feat.device)
        if sources.pieces.shape[0]:
            _, wide, error_string = load_dvals_library()
            launch(
                "spmm_ell_dvals", (wide, error_string), feat,
                sources.pieces.data_ptr(), sources.lane.data_ptr(), sources.src.data_ptr(),
                sources.row.data_ptr(), feat.data_ptr(), g.data_ptr(), out.data_ptr(),
                sources.pieces.shape[0], H, plan.num_nodes, d,
            )
            spmm_ell_dvals.launches += 1
        return out
    out = torch.empty(tb, K, dtype=torch.float32, device=feat.device)
    if tb:
        vec, sub = _k7_geometry(d, aligned)
        fn, _, error_string = load_dvals_library()
        launch(
            "spmm_ell_dvals", (fn, error_string), feat,
            plan.hind.data_ptr(), plan.erow.data_ptr(), plan.window_of_block.data_ptr(),
            feat.data_ptr(), g.data_ptr(), out.data_ptr(),
            tb * K, H, K, plan.num_nodes, plan.source_rows, d, vec, sub,
        )
        spmm_ell_dvals.launches += 1
    return out


spmm_ell_dvals.launches = 0  # plain-int launch count, read by chip_smoke.py


def _check_impl(impl: str, name: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} for {name}: it takes {', '.join(IMPLS)}")


def sddmm_ell(plan: EllPlan, x: torch.Tensor, y: torch.Tensor, *,
              per_edge: bool = False) -> torch.Tensor:
    """Sampled dense-dense product on the ELL plan, through K7: for every
    edge (u, v), x[u] . y[v]. Returns the (total_blocks, block_w) lane
    plane (0.0 on padding lanes), or with per_edge=True the (nnz,) vector
    in CSR edge order. No gradient: training takes `sddmm_ell_ad`."""
    lanes = spmm_ell_dvals(plan, y, x)
    return edge_values(plan, lanes) if per_edge else lanes


class _PlainEll(torch.autograd.Function):
    """`spmm_ell_ad(impl="reference")`: the plain versions of K6 and K7
    with the kernels' gradient (K6's over plan_t's lanes, K7's)."""

    @staticmethod
    def forward(ctx, feat, vals, plan, plan_t):
        plan = dataclasses.replace(plan, vals=vals)
        ctx.plan = plan
        ctx.plan_t = plan_t
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(feat)
        return spmm_ell_reference(plan, feat).to(feat.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous()
        dfeat = dvals = None
        if ctx.needs_input_grad[0]:
            if ctx.plan_t is None or ctx.plan_t.vals is None:
                raise ValueError(NEEDS_LANES_T)
            dfeat = spmm_ell_reference(ctx.plan_t, g)
        if ctx.needs_input_grad[1]:
            (feat,) = ctx.saved_tensors
            dvals = spmm_ell_dvals_reference(ctx.plan, feat.float().contiguous(), g)
        return dfeat, dvals, None, None


NEEDS_LANES_T = "the feature gradient needs plan_t with A^T's lane values"


def spmm_ell_ad(plan: EllPlan, plan_t: EllPlan | None, feat: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """ELL weighted SpMM with gradients for feat and for the lane values.

    The registered op ``torch.ops.voltrix.spmm_ell`` (ops/library.py) of
    (feat, plan.vals), with `plan_t` for its gradient: `plan_t` encodes A^T
    with matching lane values (build both with `format.build_ell_pair`;
    give plan_t's vals through `lane_values(plan_t, w)` for learned edges).
    Backward: d/dfeat = (A o V)^T @ g, K6 over plan_t; d/dvals = the
    per-lane dot products, K7 over plan, delivered to `plan.vals` (and
    through `lane_values` to per-edge parameters). plan_t's values get no
    gradient, as in JAX. A side whose input needs no gradient is not
    launched (plan_t may then be None). impl: "auto" or "ell" (the
    kernels), "reference" (the plain versions)."""
    from . import library

    _check_impl(impl, "spmm_ell_ad")
    if impl == "reference":
        return _PlainEll.apply(feat, plan.vals, plan, plan_t)
    _check_ell(plan, feat, "spmm_ell_ad")
    return library.call_ell(plan, feat, plan_t=plan_t).to(feat.dtype)


class _PlainSddmm(torch.autograd.Function):
    """`sddmm_ell_ad(impl="reference")`: the plain version of K7 with the
    kernels' gradient (the plain version of K6 over plan and plan_t)."""

    @staticmethod
    def forward(ctx, x, y, plan, plan_t):
        ctx.plan, ctx.plan_t = plan, plan_t
        ctx.save_for_backward(x, y)
        return edge_values(plan, spmm_ell_dvals_reference(plan, y, x))

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.float().contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            gp = dataclasses.replace(ctx.plan, vals=lane_values(ctx.plan, g))
            dx = spmm_ell_reference(gp, y.float().contiguous()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gp_t = dataclasses.replace(ctx.plan_t, vals=lane_values(ctx.plan_t, g))
            dy = spmm_ell_reference(gp_t, x.float().contiguous()).to(y.dtype)
        return dx, dy, None, None


def sddmm_ell_ad(plan: EllPlan, plan_t: EllPlan, x: torch.Tensor, y: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """Differentiable SDDMM -> (nnz,) per-edge scores x[u] . y[v] in CSR
    order: the registered op ``torch.ops.voltrix.spmm_ell_dvals`` (K7,
    ops/library.py) and the gather `edge_values`. Backward, two K6 launches
    (the SDDMM/SpMM adjoint pair): dx = (A o G) @ y over plan, dy = (A o
    G)^T @ x over plan_t, with G the score cotangents on each plan's lanes
    (on plan_t's by the lane map `ell_lane_map`). Build (plan, plan_t) with
    `format.build_ell_pair`, so both edge maps are in A's CSR edge order."""
    from . import library

    _check_impl(impl, "sddmm_ell_ad")
    if impl == "reference":
        return _PlainSddmm.apply(x, y, plan, plan_t)
    _check_dvals(plan, y, x, "sddmm_ell_ad")
    return edge_values(plan, library.call_ell_dvals(plan, y, x, plan_t=plan_t))


def ell_lane_map(plan: EllPlan, plan_t: EllPlan) -> torch.Tensor:
    """int64 (plan_t's lanes,): for each lane of plan_t, the flat lane of
    plan that holds the same CSR edge, -1 on padding lanes; built at the
    first call and kept beside plan_t's lane_edge tensor (checked against
    plan's edge_lane), so the SDDMM's gradient takes a lane plane of plan
    to plan_t's lanes by one gather."""
    if plan.edge_lane is None or plan_t.lane_edge is None:
        raise ValueError("the SDDMM's gradient needs both plans' edge maps "
                         "(build them with format.build_ell_pair)")

    def build():
        lane_edge = plan_t.lane_edge.long()
        lanes = plan.edge_lane.long().index_select(0, lane_edge.clamp(min=0))
        return torch.where(lane_edge >= 0, lanes, -1)

    return kept_beside(plan_t.lane_edge, ("lane_map", plan.num_edges), build, plan.edge_lane)

"""Weighted SpMM: kernels K4 and K5, their wrappers, plain versions and
gradient (counterpart of voltrix_spmm_tpu/ops/weighted.py).

A weighted plan (`csr_preprocess(..., values=...)`) carries a dense
float32 (total_blocks, block_h, block_w) value tile per block, aligned
with the bitmask; a plane built from per-edge tensors (models/gat.py,
models/dropedge.py) may be bfloat16 or float16.

- `spmm_weighted(plan, feat)` computes out = (A o V) @ feat through K4
  (csrc/spmm_weighted.cu, replacing weighted.py:_spmm_weighted_kernel). As
  in JAX, the whole value tile multiplies the gathered rows: the bitmask
  is not read, and a value placed off it counts. K4 reads float32,
  bfloat16 or float16 rows and a float32, bfloat16 or float16 plane, widens
  each 16-bit value exactly, sums in float32 and casts once to `out_dtype`
  (default the features' dtype), the JAX package's semantics
  (weighted.py:46, :75); its 16-bit instantiations give the float32
  kernel's bits on the widened inputs. K4 walks the work list
  of `block_spmm.plan_walk(plan, "spmm_weighted")` (each 128-row group of
  a window cut into pieces of at most PIECE_BLOCKS["spmm_weighted"]
  blocks, cut groups merged in piece order), so its sums run in a fixed
  order: two launches on one input give the same bits.
- `spmm_weighted_dvalues(plan, feat, g)` computes the value gradient
  dV[b] = mask[b] o (g_window @ feat[hind[b]]^T) through K5
  (csrc/spmm_dvalues.cu, replacing weighted.py:_dvalues_kernel): a dot
  product at each set bit only, over the work list of
  `block_spmm.plan_walk(plan, "spmm_dvalues")` (pieces of at most
  PIECE_BLOCKS["spmm_dvalues"] blocks of one window, whose g rows a thread
  block takes once), each block's plane written once; it is exactly 0.0
  off the bitmask, and two launches on one input give the same bits.
- `sddmm` and `spmm_weighted_ad` are built on the two.

K4 and K5 are the registered ops ``torch.ops.voltrix.spmm_weighted`` and
``spmm_dvalues`` (ops/library.py), which every call goes through: the
wrappers check their arguments and call the op, whose body runs the
plain versions, `spmm_weighted_reference` and
`spmm_weighted_dvalues_reference`, on a CPU tensor, and on a CUDA tensor
launches the kernel (`k4_kernel`, `k5_kernel`) or raises: there is no
fallback. K4's op carries `spmm_weighted_ad`'s gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..format.plan import SpmmPlan
from ..jit import build
from .bitmask import expand_bitmask
from .block_spmm import (
    _GROUP_WORDS,
    _INT_MAX,
    FEAT_DTYPES,
    acc_width,
    half_rows,
    cast_out,
    launch,
    walk_workspace,
)
from .reference import CHUNK_BYTES, block_sum, clipped_gather

_SMEM_LIMIT = 232448  # dynamic shared memory a thread block may use on sm_90
# K4's feature sources (csrc/spmm_walk.cuh kF32x4, kF32x1, kBF16, kF16)
_SRC_F32X4, _SRC_F32X1, _SRC_BF16, _SRC_F16 = 0, 1, 3, 4
_SRC_HALF = {torch.bfloat16: _SRC_BF16, torch.float16: _SRC_F16}
# K4's plane types (csrc/spmm_weighted.cu `plane`)
_PLANE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def load_library():
    """Build (or reuse) K4's library; return (launch, error_string)."""
    rt = build("spmm_weighted", ["spmm_weighted.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_weighted", [p] * 7 + [i] * 12 + [p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


@functools.cache
def load_dvalues_library():
    """Build (or reuse) K5's library; return (launch, error_string)."""
    rt = build("spmm_dvalues", ["spmm_dvalues.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_dvalues_f32", [p] * 6 + [i] * 9 + [p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


def _check_rows(plan: SpmmPlan, feat: torch.Tensor, name: str) -> None:
    if feat.dim() != 2 or feat.shape[0] != plan.source_rows:
        raise ValueError(
            f"{name}: feat must be (source_rows={plan.source_rows}, D), got {tuple(feat.shape)}"
        )
    if plan.src_perm is not None or plan.config.seg_interleaved:
        raise ValueError(f"{name} takes plans in natural lane order only")


def _check_kernel_args(plan: SpmmPlan, name: str, fields: dict, *tensors,
                       dtypes=(torch.float32,)) -> None:
    """What K4-K7 take: contiguous tensors of one of `dtypes` (float32;
    K4's and K6's features also bfloat16 and float16) on the plan's device, contiguous
    plan arrays of the right type (one dtype, or a tuple of those it may
    have) and shape, and row, column and block counts that fit 32-bit
    ints."""
    device = tensors[0].device
    for t in tensors:
        if t.dtype not in dtypes or not t.is_contiguous():
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{name} takes contiguous {names} tensors, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
    for field, (dtype, shape) in fields.items():
        t = getattr(plan, field)
        if t is None:
            raise ValueError(f"{name}: plan.{field} is None")
        if t.device != device:
            raise ValueError(
                f"plan.{field} is on {t.device}, feat on {device}: move the plan "
                "once with SpmmPlan.to(device) or EllPlan.to(device)"
            )
        allowed = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.dtype not in allowed or tuple(t.shape) != shape or not t.is_contiguous():
            names = " or ".join(str(d) for d in allowed)
            raise ValueError(
                f"plan.{field} must be contiguous {names} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if max(plan.num_nodes, plan.source_rows, plan.total_blocks, tensors[0].shape[1]) > _INT_MAX:
        raise ValueError(f"{name} indexes rows, blocks and columns with 32-bit ints")


def spmm_weighted_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                            chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """out = (A o V) @ feat via the plan's value tiles, accumulated in
    float32: the plain version of K4. Walks the blocks in chunks of at
    most `chunk_bytes`."""
    spmm_weighted_reference.calls += 1
    if plan.values is None:
        raise ValueError("plan has no value plane; use spmm_reference")
    _check_rows(plan, feat, "spmm_weighted_reference")
    d = feat.shape[1]
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=out_dtype, device=feat.device)
    values = plan.values

    def tiles(b0, b1):
        return values[b0:b1].float()

    out = block_sum(plan, feat, clipped_gather(plan, feat), chunk_bytes=chunk_bytes, tiles=tiles)
    return out.to(out_dtype)


spmm_weighted_reference.calls = 0  # plain-int call count, read by chip_smoke.py


K4_MAX_THREADS = 256  # csrc/spmm_weighted.cu kMaxThreads


def k4_tiling(block_h: int, block_w: int, d: int) -> tuple[int, int, int]:
    """K4's thread block for a plan geometry and width: (dc, tr, chunks).
    feat's d columns go in `chunks` chunks of dc columns (a multiple of 4,
    at most 64, as even as the multiple of 4 allows); a thread sums tr
    rows (2, 4 or 8) of four columns, tr the smallest that keeps a
    group's min(block_h, 128) rows x dc / 4 column quads within 256
    threads (tr 2 timed a little faster than 1 at d 8, 4 than 8 at d 40
    on path D's plan). K4 takes block_h and block_w in whole 32-row
    bitmask words and 32-lane slices; no tile is too tall, as the rows go
    in groups of 128."""
    if block_h <= 0 or block_h % 32 or block_w <= 0 or block_w % 32:
        raise ValueError(f"spmm_weighted needs block_h and block_w that are multiples of 32 "
                         f"(whole bitmask words and 32-lane slices), got {block_h}x{block_w}")
    quads = -(-d // 4)
    chunks = -(-quads // 16)
    if chunks > 65535:
        raise ValueError("D exceeds spmm_weighted's grid limits")
    dc = 4 * -(-quads // chunks)
    rows = min(block_h, 32 * _GROUP_WORDS)  # a work-list group's rows
    tr = next(t for t in (2, 4, 8) if rows // t * dc // 4 <= K4_MAX_THREADS)
    return dc, tr, chunks


def _check_weighted(plan: SpmmPlan, feat: torch.Tensor, name: str) -> None:
    """What K4 takes: a plan with a value plane, the features' rows, and on
    the card contiguous float32, bfloat16 or float16 features and plane and
    int32 plan arrays on the features' device."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {feat.device}")
    if plan.values is None:
        raise ValueError("plan has no value plane; use spmm_block (spmm_reference on the CPU)")
    _check_rows(plan, feat, name)
    if feat.device.type == "cuda":
        cfg = plan.config
        tb, H, K = plan.total_blocks, cfg.block_h, cfg.block_w
        _check_kernel_args(plan, name, {
            "values": (FEAT_DTYPES, (tb, H, K)),
            "hind": (torch.int32, (tb, K)),
            "block_ptr": (torch.int32, (plan.num_windows + 1,)),
        }, feat, dtypes=FEAT_DTYPES)


def spmm_weighted(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out[num_nodes, D] = (A o V) @ feat through kernel K4 (float32,
    bfloat16 or float16 rows and plane in, float32 accumulation in a fixed order, cast
    to `out_dtype`, default feat's dtype, at the end), as the registered op
    ``torch.ops.voltrix.spmm_weighted`` (ops/library.py). Every row of out
    is written (rows of windows without blocks are zero)."""
    from . import library

    _check_weighted(plan, feat, "spmm_weighted")
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    return cast_out(library.call_weighted(plan, feat), out_dtype)


def k4_kernel(plan: SpmmPlan, walk, feat: torch.Tensor) -> torch.Tensor:
    """K4 on the card over `walk`, the op's body (ops/library.py): float32
    (num_nodes, d). The value plane is read in 16-byte words; bf16 and
    float16 rows go to the kernel as `half_rows` gives them (padded once
    where d % 4 != 0 or they are not 8-byte aligned), float32 rows as they
    are."""
    if plan.values.data_ptr() % 16:
        raise ValueError("spmm_weighted reads the value plane in 16-byte words: "
                         "it must start 16-byte aligned")
    cfg = plan.config
    H, K = cfg.block_h, cfg.block_w
    d = feat.shape[1]
    dc, tr, _ = k4_tiling(H, K, d)
    out = torch.empty(plan.num_nodes, d, dtype=torch.float32, device=feat.device)
    if out.numel():
        ws = walk_workspace("spmm_weighted", walk, d, feat.device)
        if feat.dtype in _SRC_HALF:
            rows, ld = half_rows(feat)
            src = _SRC_HALF[feat.dtype]
        else:
            rows, ld = feat, d
            src = _SRC_F32X4 if d % 4 == 0 and feat.data_ptr() % 16 == 0 else _SRC_F32X1
        plane = plan.values.dtype
        launch(
            "spmm_weighted", load_library(), feat,
            plan.values.data_ptr(), plan.hind.data_ptr(), walk.tasks.data_ptr(),
            walk.merges.data_ptr(), rows.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), walk.tasks.shape[0], walk.merges.shape[0],
            H, K, plan.num_nodes, plan.source_rows, d, ld, dc, tr, src, _PLANE[plane],
        )
        spmm_weighted.launches += 1
        spmm_weighted.launches_bf16 += int(torch.bfloat16 in (feat.dtype, plane))
        spmm_weighted.launches_f16 += int(torch.float16 in (feat.dtype, plane))
    return out


spmm_weighted.launches = 0  # plain-int launch count, read by chip_smoke.py
# of which on bf16 rows or a bf16 plane (a bf16 instantiation), and on
# float16 rows or a float16 plane
spmm_weighted.launches_bf16 = 0
spmm_weighted.launches_f16 = 0


def _check_dvalues(plan: SpmmPlan, feat: torch.Tensor, g: torch.Tensor, name: str) -> None:
    _check_rows(plan, feat, name)
    if g.dim() != 2 or tuple(g.shape) != (plan.num_nodes, feat.shape[1]):
        raise ValueError(
            f"{name}: g must be (num_nodes={plan.num_nodes}, {feat.shape[1]}), "
            f"got {tuple(g.shape)}"
        )
    if plan.config.block_h % 32:
        raise ValueError(f"{name} needs block_h % 32 == 0 (whole bitmask words)")


def spmm_weighted_dvalues_reference(plan: SpmmPlan, feat: torch.Tensor, g: torch.Tensor, *,
                                    chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """d/d(plan.values) of sum(spmm_weighted(plan, feat) * g): the float32
    (total_blocks, block_h, block_w) plane dV[b, r, l] = g[w*H + r] .
    feat[hind[b, l]] where the bitmask has an edge, exactly 0.0 elsewhere.
    The plain version of K5; walks the blocks in chunks."""
    spmm_weighted_dvalues_reference.calls += 1
    _check_dvalues(plan, feat, g, "spmm_weighted_dvalues_reference")
    cfg = plan.config
    H, K = cfg.block_h, cfg.block_w
    out = torch.zeros(plan.total_blocks, H, K, dtype=torch.float32, device=feat.device)
    if plan.total_blocks == 0:
        return out
    d = feat.shape[1]
    g_win = torch.zeros(plan.padded_nodes, d, dtype=torch.float32, device=feat.device)
    g_win[: plan.num_nodes] = g
    g_win = g_win.view(plan.num_windows, H, d)
    gather = clipped_gather(plan, feat)
    wob = plan.window_of_block.long()
    step = max(1, chunk_bytes // (4 * (2 * H * K + K * d + H * d)))
    for b0 in range(0, plan.total_blocks, step):
        b1 = min(plan.total_blocks, b0 + step)
        prod = torch.bmm(g_win[wob[b0:b1]], gather(b0, b1).transpose(1, 2))
        mask = expand_bitmask(plan.bitmask[b0:b1], H, torch.bool)
        out[b0:b1] = torch.where(mask, prod, 0.0)
    return out


spmm_weighted_dvalues_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def spmm_weighted_dvalues(plan: SpmmPlan, feat: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The value gradient plane through kernel K5 (see the plain version
    for the definition), as the registered op
    ``torch.ops.voltrix.spmm_dvalues`` (ops/library.py). The plan's value
    plane is not read: any plan with exact lanes, binary or weighted, takes
    it; block_h and block_w must be multiples of 32 (whole bitmask words and
    lane slices)."""
    from . import library

    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spmm_weighted_dvalues runs on cuda or cpu tensors, not {feat.device}")
    _check_dvalues(plan, feat, g, "spmm_weighted_dvalues")
    if feat.device.type == "cuda":
        cfg = plan.config
        tb, K = plan.total_blocks, cfg.block_w
        _check_kernel_args(plan, "spmm_weighted_dvalues", {
            "bitmask": (torch.int32, (tb, cfg.words_per_col, K)),
            "hind": (torch.int32, (tb, K)),
            "block_ptr": (torch.int32, (plan.num_windows + 1,)),
        }, feat, g)
        if K % 32:
            raise ValueError(
                f"spmm_weighted_dvalues takes block_w in whole 32-lane slices, got {K}")
    return library.call_dvalues(plan, feat, g)


def k5_kernel(plan: SpmmPlan, walk, feat: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5 on the card over `walk`, the op's body (ops/library.py): float32
    (total_blocks, block_h, block_w)."""
    cfg = plan.config
    tb, H, K = plan.total_blocks, cfg.block_h, cfg.block_w
    d = feat.shape[1]
    out = torch.empty(tb, H, K, dtype=torch.float32, device=feat.device)
    if tb and d == 0:
        return out.zero_()
    if tb:
        if walk.tasks.shape[0] > _INT_MAX:
            raise ValueError("spmm_weighted_dvalues: more tasks than the grid takes")
        launch(
            "spmm_dvalues", load_dvalues_library(), feat,
            plan.bitmask.data_ptr(), plan.hind.data_ptr(), walk.tasks.data_ptr(),
            feat.data_ptr(), g.data_ptr(), out.data_ptr(), walk.tasks.shape[0],
            cfg.words_per_col, H, K, plan.num_nodes, plan.source_rows, d,
            acc_width(d),
            int(d % 4 == 0 and feat.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0),
        )
        spmm_weighted_dvalues.launches += 1
    return out


spmm_weighted_dvalues.launches = 0  # plain-int launch count, read by chip_smoke.py


def sddmm(plan: SpmmPlan, x: torch.Tensor, y: torch.Tensor, *, per_edge=None) -> torch.Tensor:
    """Sampled dense-dense product: out_uv = x[u] . y[v] for every edge
    (u, v) of the plan, through K5. Returns the (total_blocks, block_h,
    block_w) plane (zero off-edge), or with `per_edge=slots` from
    `format.edge_slot_map` the (nnz,) per-edge vector."""
    plane = spmm_weighted_dvalues(plan, y, x)
    if per_edge is not None:
        return plane.reshape(-1)[per_edge]
    return plane


class _PlainWeighted(torch.autograd.Function):
    """`spmm_weighted_ad(impl="reference")`: the plain versions of K4 and
    K5 with the kernels' gradient (K4's over plan_t's plane, K5's)."""

    @staticmethod
    def forward(ctx, feat, values, plan, plan_t):
        plan = dataclasses.replace(plan, values=values)
        # the backward reads the plan's geometry only: do not hold the plane
        ctx.plan = dataclasses.replace(plan, values=None)
        ctx.plan_t, ctx.feat_dtype = plan_t, feat.dtype
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(feat)
        return spmm_weighted_reference(plan, feat)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dfeat = dvalues = None
        if ctx.needs_input_grad[0]:
            if ctx.plan_t.values is None:
                raise ValueError(NEEDS_PLANE_T)
            # over the cotangent in the features' dtype (weighted.py:334-336)
            dfeat = spmm_weighted_reference(ctx.plan_t, g.to(ctx.feat_dtype))
        if ctx.needs_input_grad[1]:
            (feat,) = ctx.saved_tensors
            dvalues = spmm_weighted_dvalues_reference(ctx.plan, feat, g)
        return dfeat, dvalues, None, None


NEEDS_PLANE_T = "the feature gradient needs plan_t.values (A^T's plane)"


def spmm_weighted_ad(plan: SpmmPlan, plan_t: SpmmPlan, feat: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    """Weighted SpMM with gradients for feat and for the value plane.

    `plan_t` encodes A^T with the transposed values (its CSR from
    `format.csr_transpose(..., values=...)`). Backward: d/dfeat = (A o V)^T
    @ g, K4 over plan_t; d/dvalues = mask o (g @ feat^T) per block, K5
    over plan, delivered to `plan.values` (a plane built from per-edge
    tensors through `format.edge_slot_map` passes it on to them): the
    gradient of the registered op ``torch.ops.voltrix.spmm_weighted``
    (ops/library.py). The output is in feat's dtype, as JAX's. plan_t's
    values get no gradient, as in JAX. A side
    whose input needs no gradient is not launched. impl: "auto" (the
    kernels) or "reference" (the plain versions)."""
    from . import library

    if impl not in ("auto", "weighted", "reference"):
        raise ValueError(f"unknown impl {impl!r} for the weighted SpMM")
    if plan.values is None:
        raise ValueError("plan has no value plane; use spmm_ad")
    if impl == "reference":
        return _PlainWeighted.apply(feat, plan.values, plan, plan_t)
    _check_weighted(plan, feat, "spmm_weighted_ad")
    return cast_out(library.call_weighted(plan, feat, plan_t), feat.dtype)

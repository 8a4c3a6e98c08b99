"""Kernel K3, the coverage-fused SpMM, its wrapper and its plain version.

`spmm_fused(plan, feat)` computes what the JAX package's
`spmm_pallas_fused` returns, out = A @ feat, on coverage plans
(gather_segment >= 8), with the CUDA kernel in csrc/spmm_fused.cu (it
replaces voltrix_spmm_tpu/ops/pallas_spmm_fused.py:_fused_kernel; the
source says how it is laid out and what bounds it). X arrives in runs of
`gather_segment` consecutive rows that start at the run heads
hind[:, ::seg]; rows past the last source row read as zero.

The kernel walks the work list of ops/block_spmm.py (`plan_walk(plan,
"spmm_fused")`): each slab of a window (`group_words`: 256 rows on
windows taller than 128 rows) cut into pieces of at most
PIECE_BLOCKS["spmm_fused"] blocks and about PIECE_WORK["spmm_fused"]
units of work, the pieces summed in piece order, so two launches give the
same bits.

The wrapper calls the registered op ``torch.ops.voltrix.spmm_fused``
(ops/library.py), which runs the plain version, `spmm_fused_reference`,
on a CPU tensor, and on a CUDA tensor launches the kernel or raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.plan import SpmmPlan
from ..jit import build
from .block_spmm import _INT_MAX, HALF_DTYPES, half_rows, launch, run_op, walk_workspace
from .reference import CHUNK_BYTES, block_sum, check_binary

_COLS = 128  # feature columns a thread block of the kernel sums (csrc/spmm_fused.cu kCols)
_TILE_LANES = 128  # lanes of a block staged at once (csrc/spmm_fused.cu kTileLanes)


@functools.cache
def load_library():
    """Build (or reuse) the kernel library; return (launch, error_string)."""
    rt = build("spmm_fused", ["spmm_fused.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = rt.function("voltrix_spmm_fused_f32", [p] * 7 + [i] * 11 + [p])
    return fn, rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)


@functools.cache
def load_bf16_library():
    """K3's bf16 instantiation from the same build; return (launch,
    error_string)."""
    rt = build("spmm_fused", ["spmm_fused.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    return (rt.function("voltrix_spmm_fused_bf16", [p] * 7 + [i] * 12 + [p]),
            load_library()[1])


@functools.cache
def load_f16_library():
    """K3's float16 instantiation from the same build; return (launch,
    error_string)."""
    rt = build("spmm_fused", ["spmm_fused.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    return (rt.function("voltrix_spmm_fused_f16", [p] * 7 + [i] * 12 + [p]),
            load_library()[1])


def box_rows(seg: int) -> int:
    """Rows of one tensor-map box of K3's bulk copies (csrc/spmm_fused.cu
    box_rows): the largest power of two that divides both `seg` and a
    tile's 128 lanes, so that no box crosses a run's or a tile's edge."""
    return min(seg & -seg, _TILE_LANES)


def _check_geometry(plan: SpmmPlan) -> None:
    cfg = plan.config
    if cfg.gather_segment < 8:
        raise ValueError(
            f"the fused SpMM needs a coverage plan (gather_segment >= 8), got "
            f"gather_segment={cfg.gather_segment}"
        )
    if cfg.block_w % 128 or cfg.block_h % 32:
        raise ValueError(
            f"the fused SpMM needs block_w % 128 == 0 and block_h % 32 == 0, "
            f"got {cfg.block_h}x{cfg.block_w}"
        )
    if plan.total_blocks % cfg.block_unroll:
        raise ValueError(
            f"total_blocks={plan.total_blocks} is not a multiple of "
            f"block_unroll={cfg.block_unroll}"
        )


def spmm_fused_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                         chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The plain version of K3: gather each seg-run from its head
    hind[b, j*seg] (rows >= source_rows read as zero), then the masked
    block sum of `spmm_reference`."""
    spmm_fused_reference.calls += 1
    check_binary(plan, feat)
    _check_geometry(plan)
    n, d = feat.shape
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=out_dtype, device=feat.device)
    seg, k = plan.config.gather_segment, plan.config.block_w
    heads = plan.hind[:, ::seg].long()  # (TB, K / seg) run starts
    offs = torch.arange(seg, device=feat.device)

    def gather(b0, b1):
        rows = (heads[b0:b1, :, None] + offs).reshape(-1)
        xg = feat.index_select(0, rows.clamp(max=n - 1)).float()
        xg = torch.where((rows < n)[:, None], xg, 0.0)
        return xg.reshape(b1 - b0, k, d)

    return block_sum(plan, feat, gather, chunk_bytes=chunk_bytes).to(out_dtype)


spmm_fused_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def launch_fused(library, plan: SpmmPlan, walk, feat: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K3 (`library`) over `walk` into `out` (num_nodes, d), with a
    workspace for the cut slabs' pieces 1.. (the library's merge kernel
    then sums them into out). bf16 or float16 features take that
    instantiation (`library` its), on rows of the width `half_rows` gives
    them."""
    cfg = plan.config
    d = feat.shape[1]
    if walk.tasks.shape[0] * -(-d // _COLS) > _INT_MAX:
        raise ValueError("pieces x column chunks exceed spmm_fused's grid limits")
    ws = walk_workspace("spmm_fused", walk, d, feat.device)
    # the last int: bulk copies (TMA) of 16-byte aligned rows whose width
    # is a multiple of 16 bytes, in boxes of at least 8 rows, or cp.async
    # (4 bytes a float32 value, 8 bytes four 16-bit values)
    widths = (d,)
    if feat.dtype in HALF_DTYPES:
        feat, ld = half_rows(feat)
        widths = (d, ld)
    row_bytes = widths[-1] * feat.element_size()
    bulk = int(row_bytes % 16 == 0 and feat.data_ptr() % 16 == 0
               and box_rows(cfg.gather_segment) >= 8)
    launch(
        "spmm_fused", library, feat,
        plan.bitmask.data_ptr(), plan.hind.data_ptr(), walk.tasks.data_ptr(),
        walk.merges.data_ptr(), feat.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), walk.tasks.shape[0], walk.merges.shape[0],
        cfg.words_per_col, walk.group_words, cfg.block_h, cfg.block_w, cfg.gather_segment,
        plan.num_nodes, plan.source_rows, *widths, bulk,
    )


def spmm_fused(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *, plan_t=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K3 (float32, bf16 or float16 in,
    float32 accumulation, cast to `out_dtype` at the end), as the registered op
    ``torch.ops.voltrix.spmm_fused`` (ops/library.py); `plan_t` as in
    `spmm_block`."""
    _check_geometry(plan)
    return run_op("spmm_fused", plan, feat, out_dtype, plan_t)


spmm_fused.launches = 0  # plain-int launch count (in ops/library.py), read by chip_smoke.py
spmm_fused.launches_bf16 = 0  # of which on bf16 features (the bf16 instantiation)
spmm_fused.launches_f16 = 0  # of which on float16 features (the float16 instantiation)

"""Kernel K1, the block SpMM, its wrapper, and the work list that K1, K2
and K8 share.

`spmm_block(plan, feat)` computes what the JAX package's
`spmm_pallas(subtile=False)` returns, out = A @ feat, with the CUDA
kernel in csrc/spmm_block.cu (it replaces
voltrix_spmm_tpu/ops/pallas_spmm.py:_spmm_block_kernel; the source and
csrc/spmm_walk.cuh say how it is laid out and what bounds it). The
library is built with nvcc at first use (see jit/compiler.py).

The three kernels walk a list of tasks: each 128-row group of a window cut
into pieces of at most `PIECE_BLOCKS[name]` visited blocks and about
`PIECE_WORK[name]` units of work (`window_pieces`, `walk_tasks`,
`block_work`). Kernels K4 and K5 (ops/weighted.py) take the same list with
a block limit alone, as their blocks cost about the same; kernel K3
(ops/fused_spmm.py) takes it with groups of 256 rows on windows taller
than 128 rows (`group_words`); kernels K9-K15 (ops/attention.py:
attention_walk) take it for their row walks. The list is built on the
host from the plan's block_ptr, each block's work (and K2's
occupancy) at a plan's first launch for each kernel, the only host sync,
and kept beside the plan's block_ptr tensor, outside its dataclass
fields (`plan_walk`).

The wrapper calls the registered op ``torch.ops.voltrix.spmm_block``
(ops/library.py), which runs the plain version,
`ops.reference.spmm_reference`, on a CPU tensor, and on a CUDA tensor
launches the kernel or raises: there is no fallback.

K1, K2, K3, K4 and K6 read float32, bfloat16 or float16 feature rows
(`FEAT_DTYPES`; K8 quantizes them): a 16-bit row
is read as 2-byte values and widened exactly to float32 in the kernel, the
sums are float32 in the kernel's order, and the result is cast once to
`out_dtype` (default: the features' dtype), the JAX package's semantics
(pallas_spmm.py:192, :263). The 16-bit rows go to the kernels as
`half_rows` gives them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..format.plan import SpmmPlan
from ..jit import build
from ..utils import kept_beside
from .reference import check_binary

_COLS = 32  # the grid's column unit in _check
_GROUP_WORDS = 4  # 32-row words per thread block (csrc/spmm_walk.cuh kWarps)
_INT_MAX = 2**31 - 1
# the feature types the CUDA kernels K1, K2, K3, K4 and K6 read, and K8
# quantizes (K5 and K7 read float32)
FEAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the 16-bit feature types, each read by its own instantiation of a kernel
HALF_DTYPES = (torch.bfloat16, torch.float16)
MAX_PIECE_BLOCKS = 256  # csrc/spmm_walk.cuh kMaxPiece
# a piece holds at most PIECE_BLOCKS blocks and about PIECE_WORK units of
# work (`block_work`; None: no work limit), by kernel:
# python3 -m voltrix_spmm_tpu_torch.tools.spmm_piece_sweep (paths A and B;
# K8 on paths I and C; K4 and K5 on path D's plans; K3 on paths C and J.2)
# and, for K9 ("spmm_attention"), K10 ("attention_bwd", its dq walk), K13
# ("spmm_attention_mh"), K14 ("attention_mh_dq"), K15 ("attention_mh_dkv", on
# the transpose plan) and their one-head launches K11 ("attention_dq") and
# K12 ("attention_dkv"), python3 -m voltrix_spmm_tpu_torch.tools.attn_task_sweep
# (paths H and G)
PIECE_BLOCKS = {"spmm_block": 32, "spmm_subtile": 64, "spmm_int8": 128, "spmm_weighted": 8,
                "spmm_fused": 4096, "spmm_attention": 32, "attention_bwd": 32,
                "spmm_attention_mh": 32, "spmm_dvalues": 2, "attention_mh_dq": 32,
                "attention_mh_dkv": 32, "attention_dq": 32, "attention_dkv": 32}
PIECE_WORK = {"spmm_block": 2048, "spmm_subtile": 1024, "spmm_int8": 2048,
              "spmm_weighted": None, "spmm_fused": 8192, "spmm_attention": 512,
              "attention_bwd": 512, "spmm_attention_mh": 1024, "spmm_dvalues": None,
              "attention_mh_dq": 1024, "attention_mh_dkv": 1024, "attention_dq": 512,
              "attention_dkv": 512}
# the most blocks a piece may hold (csrc/spmm_walk.cuh kMaxPiece), by kernel:
# K3, K5 and K9-K15 walk a piece's block range in order and hold no list of
# its blocks
PIECE_BLOCKS_CAP = {"spmm_fused": None, "spmm_attention": None, "attention_bwd": None,
                    "spmm_attention_mh": None, "spmm_dvalues": None, "attention_mh_dq": None,
                    "attention_mh_dkv": None, "attention_dq": None, "attention_dkv": None}
# 32-row words of a work-list group on windows taller than four words, by
# kernel (default _GROUP_WORDS): K3 stages a block's X rows once for a slab
# of 256 rows (csrc/spmm_fused.cu)
TALL_GROUP_WORDS = {"spmm_fused": 8}


# columns a lane of K5, K9 or K10 keeps in registers (the kernels' template
# widths)
ACC_WIDTHS = (8, 16, 32, 40, 64)


def acc_width(d: int) -> int:
    """The narrowest of ACC_WIDTHS that holds d columns, else the widest (d
    in chunks of it)."""
    return next((w for w in ACC_WIDTHS if w >= d), ACC_WIDTHS[-1])


@functools.cache
def load_library():
    """Build (or reuse) the kernel library; return (launch, error_string)."""
    rt = build("spmm_block", ["spmm_block.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = rt.function("voltrix_spmm_block_f32", [p] * 7 + [i] * 9 + [p])
    error_string = rt.function("voltrix_cuda_error_string", [i], ctypes.c_char_p)
    return launch, error_string


@functools.cache
def load_bf16_library():
    """K1's bf16 instantiation from the same build; return (launch,
    error_string)."""
    rt = build("spmm_block", ["spmm_block.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    return (rt.function("voltrix_spmm_block_bf16", [p] * 7 + [i] * 9 + [p]),
            load_library()[1])


@functools.cache
def load_f16_library():
    """K1's float16 instantiation from the same build; return (launch,
    error_string)."""
    rt = build("spmm_block", ["spmm_block.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int
    return (rt.function("voltrix_spmm_block_f16", [p] * 7 + [i] * 9 + [p]),
            load_library()[1])


def library_for(module, dtype):
    """`module`'s kernel library for feature rows of `dtype`: its bf16 or
    float16 instantiation (`load_bf16_library`, `load_f16_library`), else
    its float32 one."""
    if dtype == torch.bfloat16:
        return module.load_bf16_library()
    if dtype == torch.float16:
        return module.load_f16_library()
    return module.load_library()


def count_launch(wrapper, dtype) -> None:
    """One launch of `wrapper`'s kernel on rows of `dtype`: `launches`, and
    `launches_bf16` or `launches_f16` for a 16-bit instantiation."""
    wrapper.launches += 1
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    elif dtype == torch.float16:
        wrapper.launches_f16 += 1


def _check(plan: SpmmPlan, feat: torch.Tensor, name: str = "spmm_block",
           dtypes=FEAT_DTYPES) -> None:
    """What every CUDA SpMM kernel of the port takes: row-major features
    of one of `dtypes` on the plan's device, a binary plan in natural lane
    order with contiguous int32 arrays, and 32-bit row and column indices."""
    _check_feat(plan, feat, name, dtypes)
    _check_plan(plan, feat.device, name)


def _check_feat(plan: SpmmPlan, feat: torch.Tensor, name: str, dtypes=FEAT_DTYPES) -> None:
    """`_check`'s part that reads the features and the plan's kind."""
    cfg = plan.config
    if feat.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise TypeError(f"{name} takes {names} features, got {feat.dtype}")
    if feat.dim() != 2 or feat.shape[0] != plan.source_rows:
        raise ValueError(
            f"feat must be (source_rows={plan.source_rows}, D), got {tuple(feat.shape)}"
        )
    if not feat.is_contiguous():
        raise ValueError(f"{name} needs row-major contiguous features")
    if plan.values is not None:
        raise ValueError(
            f"plan carries a value plane; use ops.spmm(plan, feat) or "
            f"spmm_weighted: {name} is the binary SpMM"
        )
    if plan.src_perm is not None or cfg.seg_interleaved:
        raise ValueError(
            f"{name} takes binary plans in natural lane order only "
            "(no src_perm or seg_interleaved)"
        )
    if max(plan.num_nodes, plan.source_rows, feat.shape[1]) > _INT_MAX:
        raise ValueError(f"{name} indexes rows and columns with 32-bit ints")
    if -(-feat.shape[1] // _COLS) > 65535:
        raise ValueError(f"D exceeds {name}'s grid limits")


def _check_plan(plan: SpmmPlan, device: torch.device, name: str) -> None:
    """`_check`'s part that reads the plan's tensors alone."""
    cfg = plan.config
    shapes = {
        "bitmask": (plan.total_blocks, cfg.words_per_col, cfg.block_w),
        "hind": (plan.total_blocks, cfg.block_w),
        "block_ptr": (plan.num_windows + 1,),
    }
    if plan.occ is not None:
        shapes["occ"] = (plan.total_blocks,)
    for field, shape in shapes.items():
        t = getattr(plan, field)
        if t.device != device:
            raise ValueError(
                f"plan.{field} is on {t.device}, feat on {device}: move the "
                "plan once with SpmmPlan.to(device)"
            )
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"plan.{field} must be contiguous int32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if max(plan.num_nodes, plan.source_rows) > _INT_MAX:
        raise ValueError(f"{name} indexes rows and columns with 32-bit ints")


def window_pieces(block_ptr, piece_blocks: int, visit=None, work=None, piece_work=None):
    """Cut each window's blocks into pieces: (window, begin, end, visits)
    int64 arrays, one entry per piece, a window's pieces in block order. A
    piece is the block range [begin, end) that holds at most `piece_blocks`
    of the blocks the walk visits: every block (K1), or those where the
    bool (total_blocks,) `visit` is set (K2: the blocks with one
    sub-window's occupancy bit), a piece then spanning its first to its
    last. With `work` (int (total_blocks,)) a piece also ends where the
    window's visited blocks before it reach the next multiple of
    `piece_work`, so it holds at most piece_work plus one block's work. A
    window without a visited block gets one empty piece. A window's cut
    depends on its own blocks alone, so it is the same in a window chunk of
    the plan."""
    if piece_blocks < 1:
        raise ValueError(f"piece_blocks must be >= 1, got {piece_blocks}")
    bp = np.asarray(block_ptr, dtype=np.int64)
    blocks = np.arange(bp[-1]) if visit is None else np.flatnonzero(visit)
    window = np.searchsorted(bp, blocks, side="right") - 1
    first = np.searchsorted(window, window)  # the window's first visited block
    piece = (np.arange(len(blocks)) - first) // piece_blocks
    change = np.r_[True, (window[1:] != window[:-1]) | (piece[1:] != piece[:-1])]
    if work is not None:
        done = np.cumsum(np.asarray(work, dtype=np.int64)[blocks])
        done -= done[first] - np.asarray(work, dtype=np.int64)[blocks][first]
        done -= np.asarray(work, dtype=np.int64)[blocks]  # before the block
        share = done // piece_work
        change[1:] |= share[1:] != share[:-1]
    starts = np.flatnonzero(change) if len(blocks) else blocks
    ends = np.append(starts[1:], len(blocks)) if len(blocks) else blocks
    empty = np.setdiff1d(np.arange(len(bp) - 1), window)
    window = np.r_[window[starts], empty]
    begin = np.r_[blocks[starts], bp[empty]]
    end = np.r_[blocks[ends - 1] + 1, bp[empty]]
    visits = np.r_[ends - starts, np.zeros(len(empty), np.int64)]
    order = np.argsort(window, kind="stable")
    return window[order], begin[order], end[order], visits[order]


def walk_tasks(block_ptr, piece_blocks: int, groups: int, occ=None, work=None,
               piece_work=None):
    """The work list of csrc/spmm_walk.cuh: int32 (tasks, 6) rows (window,
    group, first block, end block, rank of the piece among the group's
    pieces, the group's first workspace slot or -1), int32 (cut groups, 4)
    rows (window, group, first workspace slot, pieces), and the number of
    workspace slots. A task is a piece of one 128-row group of a window
    (`window_pieces`); with `occ` (int32 (total_blocks,), K2's sub-window
    bits) group g's pieces count the blocks with bit g, else every block;
    `work` (int (total_blocks, groups)) is each block's work in each group.
    A group of two or more pieces is cut: its pieces 1.. each get a
    workspace slot. Tasks with more blocks to walk come first."""
    parts = []
    for g in range(groups):
        visit = None if occ is None else (np.asarray(occ, dtype=np.int64) >> g) & 1 == 1
        w_g = None if work is None else np.asarray(work)[:, g]
        window, begin, end, visits = window_pieces(block_ptr, piece_blocks, visit, w_g,
                                                   piece_work)
        parts.append((window, np.full_like(window, g), begin, end, visits))
    window, group, begin, end, visits = (np.concatenate(x) for x in zip(*parts))
    key = window * groups + group
    order = np.argsort(key, kind="stable")  # a group's pieces together, in order
    window, group, begin, end, visits, key = (
        x[order] for x in (window, group, begin, end, visits, key))
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    count = np.diff(np.r_[starts, len(key)])
    rank = np.arange(len(key)) - np.repeat(starts, count)
    cut = count > 1
    slot = np.full(len(count), -1, np.int64)
    slot[cut] = np.cumsum(count[cut] - 1) - (count[cut] - 1)
    tasks = np.stack([window, group, begin, end, rank, np.repeat(slot, count)], axis=1)
    tasks = tasks[np.argsort(-visits, kind="stable")]
    merges = np.stack([window[starts][cut], group[starts][cut], slot[cut], count[cut]], axis=1)
    return (tasks.astype(np.int32), merges.astype(np.int32).reshape(-1, 4),
            int((count[cut] - 1).sum()))


def group_words(name: str, words: int) -> int:
    """32-row words of one work-list group of kernel `name` on windows of
    `words` words: 4 (a thread block of four warps), or on windows taller
    than 128 rows the kernel's TALL_GROUP_WORDS (K3: 8)."""
    return TALL_GROUP_WORDS.get(name, _GROUP_WORDS) if words > _GROUP_WORDS else _GROUP_WORDS


def block_work(plan: SpmmPlan, gw: int = _GROUP_WORDS) -> torch.Tensor:
    """int64 (total_blocks, groups) on the plan's device: for each block
    and group of `gw` 32-row words, the work of the group's busiest warp in
    the walk, its kept (lane, word) pairs plus their nonzero bitmask
    bytes."""
    tb, words, k = plan.bitmask.shape
    groups = -(-words // gw)
    valid = (plan.hind >= 0) & (plan.hind < plan.source_rows)
    out = []
    step = max(1, 2**22 // max(1, words * k))
    for b0 in range(0, tb, step):
        bm = plan.bitmask[b0:b0 + step]
        work = (bm != 0).long()
        for byte in range(4):
            work += ((bm >> (8 * byte)) & 0xFF) != 0
        work = (work * valid[b0:b0 + step, None, :]).sum(2)  # (c, words)
        work = torch.nn.functional.pad(work, (0, groups * gw - words))
        out.append(work.view(-1, groups, gw).amax(2))
    if not out:
        return torch.zeros(0, groups, dtype=torch.int64, device=plan.device)
    return torch.cat(out)


@dataclass
class Walk:
    """A plan's work list on its device, as `walk_tasks` built it."""

    tasks: torch.Tensor  # int32 (num_tasks, 6)
    merges: torch.Tensor  # int32 (cut groups, 4)
    slots: int  # workspace tiles of cut groups
    rows: int  # rows of a workspace tile
    cut_windows: int  # windows with a cut group
    occ: torch.Tensor | None  # K2's sub-window bits, on the plan's device
    group_words: int = _GROUP_WORDS  # 32-row words of a group (`group_words`)


def plan_walk(plan: SpmmPlan, name: str, occupancy=None) -> Walk:
    """`plan`'s work list for kernel `name`, built at the first call (one
    host copy of block_ptr, of each block's work where the kernel has a
    work limit, and of the occupancy that `occupancy()` returns for K2) and
    kept beside the plan's block_ptr tensor (`utils.kept_beside`, checked
    against its bitmask, hind and occ tensors), keyed by the kernel and its
    piece limits: a copy of the plan that shares these tensors, such as the
    `dataclasses.replace(plan, values=...)` of every GAT head, finds it."""
    piece_blocks, piece_work = PIECE_BLOCKS[name], PIECE_WORK[name]
    cap = PIECE_BLOCKS_CAP.get(name, MAX_PIECE_BLOCKS)
    if piece_blocks < 1 or (cap is not None and piece_blocks > cap):
        raise ValueError(f"PIECE_BLOCKS[{name!r}] must be in 1..{cap}")
    words = plan.config.words_per_col
    gw = group_words(name, words)

    def build():
        occ = None if occupancy is None else occupancy()
        work = None if piece_work is None else block_work(plan, gw).cpu().numpy()
        tasks, merges, slots = walk_tasks(
            plan.block_ptr.cpu().numpy(), piece_blocks, -(-words // gw),
            None if occ is None else occ.cpu().numpy(), work, piece_work)
        return Walk(
            tasks=torch.from_numpy(tasks).to(plan.device),
            merges=torch.from_numpy(merges).to(plan.device), slots=slots,
            rows=32 * min(words, gw),
            cut_windows=len(np.unique(merges[:, 0])), occ=occ, group_words=gw)

    key = ("walk", name, piece_blocks, piece_work, words, plan.source_rows)
    return kept_beside(plan.block_ptr, key, build, plan.bitmask, plan.hind, plan.occ)


def walk_stats(plan: SpmmPlan, walk: Walk, d: int) -> dict:
    """What a plan's work list gives the kernel (for chip_smoke.py and the
    sweep): pieces (tasks), windows and groups cut, the kept (lane, word)
    pairs and the work (`block_work`) of the heaviest piece against the
    mean, and the workspace in MiB at width d."""
    tb, words, _ = plan.bitmask.shape
    gw = walk.group_words
    groups = -(-words // gw)
    valid = (plan.hind >= 0) & (plan.hind < plan.source_rows)
    pairs = ((plan.bitmask != 0) & valid[:, None, :]).sum(2)  # (tb, words)
    pairs = torch.nn.functional.pad(pairs, (0, groups * gw - words))
    t = walk.tasks.long()
    stats = {"pieces": int(t.shape[0]), "cut_windows": walk.cut_windows,
             "cut_groups": int(walk.merges.shape[0]),
             "workspace_mib": walk.slots * walk.rows * d * 4 / 2**20}
    for name, per_block in (("pairs", pairs.view(tb, groups, gw).sum(2)),
                            ("work", block_work(plan, gw))):
        if walk.occ is not None:
            shifts = torch.arange(groups, dtype=torch.int32, device=per_block.device)
            per_block = per_block * ((walk.occ[:, None] >> shifts) & 1)
        cum = torch.cat([per_block.new_zeros(1, groups), per_block.cumsum(0)])
        per_task = cum[t[:, 3], t[:, 1]] - cum[t[:, 2], t[:, 1]]
        stats[f"max_task_{name}"] = int(per_task.max())
        stats[f"mean_task_{name}"] = float(per_task.float().mean())
    return stats


def walk_workspace(name: str, walk: Walk, d: int, device) -> torch.Tensor | None:
    """The workspace of `walk`'s cut groups' pieces 1.. at width d (None if
    no group is cut); raises if the list outgrows the grid."""
    if walk.tasks.shape[0] > _INT_MAX or walk.merges.shape[0] * walk.rows // 4 > _INT_MAX:
        raise ValueError(f"{name}: more tasks than the grid takes")
    if not walk.slots:
        return None
    return torch.empty(walk.slots * walk.rows * d, dtype=torch.float32, device=device)


def half_compute(compute_dtype) -> torch.dtype | None:
    """The JAX package's compute_dtype on the port: torch.bfloat16 or
    torch.float16 (the features are rounded to it, round to nearest even,
    and read by the kernels' 16-bit sources), None for None and float32
    (the kernels' own); any other type raises."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return None
    if compute_dtype in HALF_DTYPES:
        return compute_dtype
    raise NotImplementedError(
        f"compute_dtype={compute_dtype}: the SpMM kernels compute in float32 from float32, "
        "bfloat16 or float16 rows")


def half_rows(feat: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(rows, ld): bf16 or float16 features as the kernels' 16-bit sources
    read them, rows of a width ld that is a multiple of 4, 8-byte aligned.
    cp.async copies 4, 8 or 16 bytes and has no 2-byte copy, so where d % 4
    != 0 or the rows are not 8-byte aligned they are padded here, once a
    call, with zero columns into a fresh (source_rows, ld) tensor (a copy
    of X in its dtype, on the card, inside the timed call); else feat
    itself."""
    n, d = feat.shape
    if d % 4 == 0 and feat.data_ptr() % 8 == 0:
        return feat, d
    ld = d + (-d % 4)
    rows = feat.new_zeros(n, ld)
    rows[:, :d] = feat
    return rows, ld


def launch_walk(name: str, library, plan: SpmmPlan, feat: torch.Tensor, out: torch.Tensor,
                walk: Walk, scale: torch.Tensor | None = None) -> None:
    """Launch K1, K2 or K8 (`library`) over `walk` into `out` (num_nodes,
    d): `feat` is float32 (source_rows, d) rows, bf16 or float16 rows
    (`library` that instantiation; padded by `half_rows` where needed), or with
    `scale` K8's int8 (source_rows, d4) rows and their float32 scales;
    with a workspace for the cut groups' pieces 1.. (the library's second
    kernel then sums them into out)."""
    d = out.shape[1]
    ws = walk_workspace(name, walk, d, feat.device)
    cfg = plan.config
    occ = () if walk.occ is None else (walk.occ.data_ptr(),)
    if scale is not None:  # the last int: the int8 rows' width d4
        rows, last = (feat.data_ptr(), scale.data_ptr()), feat.shape[1]
    elif feat.dtype in HALF_DTYPES:  # the last int: the 16-bit rows' width ld
        feat, last = half_rows(feat)
        rows = (feat.data_ptr(),)
    else:  # the last int: 16-byte copies of float32 rows, or 4-byte ones
        rows, last = (feat.data_ptr(),), int(d % 4 == 0 and feat.data_ptr() % 16 == 0)
    launch(
        name, library, feat, plan.bitmask.data_ptr(), plan.hind.data_ptr(), *occ,
        walk.tasks.data_ptr(), walk.merges.data_ptr(), *rows, out.data_ptr(),
        None if ws is None else ws.data_ptr(), walk.tasks.shape[0], walk.merges.shape[0],
        cfg.words_per_col, cfg.block_h, cfg.block_w, plan.num_nodes, plan.source_rows, d, last,
    )


def launch(name: str, library, feat: torch.Tensor, *args) -> None:
    """Call `library`'s launch function on the current stream of feat's
    device; raise with CUDA's message if the launch was refused."""
    fn, error_string = library
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(rc).decode()} ({rc})")


def cast_out(out: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype is None or out_dtype == torch.float32:
        return out
    return out.to(out_dtype)


def spmm_block(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *, plan_t=None) -> torch.Tensor:
    """out[num_nodes, D] = A @ feat through kernel K1 (float32, bf16 or
    float16 in, float32 accumulation, cast to `out_dtype` at the end), as the registered op
    ``torch.ops.voltrix.spmm_block`` (ops/library.py). With `plan_t` (A^T's
    plan) the result is differentiable in feat: its gradient is the op of
    plan_t's kind over plan_t."""
    return run_op("spmm_block", plan, feat, out_dtype, plan_t)


def run_op(kind: str, plan: SpmmPlan, feat: torch.Tensor, out_dtype, plan_t) -> torch.Tensor:
    """The wrappers' body: check (on the CPU the plain version checks), call
    the registered op `kind`, cast to `out_dtype` (default feat's dtype)."""
    from . import library

    if feat.device.type == "cuda":
        _check(plan, feat, kind)
    elif feat.device.type == "cpu":
        check_binary(plan, feat)
    else:
        raise ValueError(f"{kind} runs on cuda or cpu tensors, not {feat.device}")
    out = library.call(kind, plan, feat, plan_t)
    return cast_out(out, feat.dtype if out_dtype is None else out_dtype)


spmm_block.launches = 0  # plain-int launch count (in ops/library.py), read by chip_smoke.py
spmm_block.launches_bf16 = 0  # of which on bf16 features (the bf16 instantiation)
spmm_block.launches_f16 = 0  # of which on float16 features (the float16 instantiation)

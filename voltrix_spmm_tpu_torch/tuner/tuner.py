"""Kernel-variant autotuner with a persistent cache (counterpart of
voltrix_spmm_tpu/tuner/tuner.py), racing the port's own kernels.

The mechanism is the JAX package's:

- the space is a list of `Variant`s: plan geometry (window height, block
  width, gather segment, unroll, column clustering) and the kernel that
  runs it (K1, K2, K3, the hybrid K3 + K1/K2, K4, K6, K8);
- every candidate is timed on its plan, and the fastest wins; orderings of
  the rows ("identity", "rcm", "degree") race as well;
- a candidate that the kernels refuse (a geometry `ValueError`) or that
  runs out of device memory is skipped; any other failure (a launch that
  leaves the CUDA context broken) stops the race with its message, so no
  candidate ever falls back to a plain version on the card;
- results are cached in memory and on disk, keyed by matrix hash (or the
  caller's `hash_tag`), feature shape and dtype, the device, and a code
  version pinned at first use; a soft time budget stops the race early, a
  race cut short resumes from its `.partial` file, and `isolate=True` times
  each candidate in a subprocess of its own (tuner/probe.py).

On the card a candidate is timed by `utils.gpu_bench` (CUDA events, the
L2 flushed before each launch, the median); on the CPU, where the wrappers
run their plain versions, by `utils.CPU_bench`, which only the tests use.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import logging
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..format.plan import PlanConfig
from ..format.preprocess import FUSED_COVERAGE_THRESHOLD, csr_preprocess
from ..ops.block_spmm import PIECE_BLOCKS, PIECE_WORK, group_words
from ..project import const
from ..utils import CPU_bench, env_flag, gpu_bench

IMPLS = ("pregather", "fused", "hybrid", "int8", "ell", "weighted")
# the dtypes a Variant's feat_dtype and compute_dtype may name: the
# kernels' bf16 sources (K1, K2, K3, K4, K6; K8 quantizes bf16 rows) and
# their own float32
FEAT_DTYPES = ("float32", "bfloat16")
# f32 edge-feature volume (nnz x d x 4) past which the default space is
# budgeted against device memory and candidates race in probes of their own
HUGE_BYTES = 4 * 2**30


@dataclass(frozen=True)
class Variant:
    """One candidate: the JAX package's field names, where they mean the
    same thing. impl: "pregather" (K1, or K2 with `subtile`), "fused"
    (K3), "hybrid" (K3 on the dense runs, K1 or K2 on the rest), "int8"
    (K8), "ell" (K6) or "weighted" (K4). stream_chunks runs "pregather" and
    "ell" plans window chunk by window chunk. feat_dtype="bfloat16" casts
    the caller's features to bf16 before the SpMM, and
    compute_dtype="bfloat16" has the SpMM round them (K6: and its edge
    values) itself; both run the kernels' bf16 sources (K1, K2, K3, K6;
    "weighted" and "int8" take feat_dtype alone: K4 reads bf16 rows and K8
    quantizes them in bf16, and the JAX package's K4 and K8 take no
    compute_dtype), and the result returns in the caller's dtype, the
    float32 sums cast to it once. The JAX package's TPU knobs raise
    NotImplementedError with their reason."""

    impl: str
    block_h: int = 128
    block_w: int = 128
    gather_segment: int = 1
    block_d: int | None = None
    compute_dtype: str = "float32"
    precision: str | None = None
    threshold: int | None = None  # hybrid: fewest neighbours of a dense run
    block_unroll: int = 1
    subtile: bool = False  # column-clustered plan; K2 skips empty sub-windows
    feat_dtype: str | None = None
    slots: int | None = None
    stream_chunks: int | None = None
    pack_order: str = "natural"
    hybrid_dense: str = "fused"
    ipack: bool = False

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}: the port races {', '.join(IMPLS)}")
        for name in ("feat_dtype", "compute_dtype"):
            value = getattr(self, name)
            if value is not None and value not in FEAT_DTYPES:
                raise NotImplementedError(
                    f"Variant {name}={value!r}: the SpMM kernels read float32 or bfloat16 rows; "
                    "float16 features are ROADMAP.md item 9")
        if self.compute_dtype == "bfloat16" and self.impl in ("int8", "weighted"):
            raise NotImplementedError(
                f"Variant {self.impl!r} with compute_dtype='bfloat16': the JAX package's K4 and "
                "K8 take no compute_dtype (its variant would race float32 rows under a bf16 "
                "key); feat_dtype='bfloat16' runs them on bf16 rows")
        refused = {
            "block_d": (self.block_d is not None,
                        "a TPU tiling knob; the H100 kernels pick their own tiles"),
            "slots": (self.slots is not None,
                      "the TPU pipeline depth; the H100 kernels stage their own copies"),
            "precision": (self.precision is not None,
                          "a TPU matmul knob; the H100 kernels compute in float32"),
            "pack_order": (self.pack_order != "natural",
                           "pack_order='incidence' is a TPU gather layout (ROADMAP.md item 18)"),
            "ipack": (self.ipack, "seg_interleaved is a TPU gather layout (ROADMAP.md item 18)"),
            "hybrid_dense": (self.hybrid_dense != "fused",
                             "the packed super-row dense side is a TPU gather layout "
                             "(ROADMAP.md item 18); the port's dense side is K3"),
        }
        for name, (given, why) in refused.items():
            if given:
                raise NotImplementedError(f"Variant {name}: {why}")
        if self.stream_chunks and self.impl not in ("pregather", "ell"):
            raise ValueError(f"stream_chunks runs impl 'pregather' or 'ell', not {self.impl!r}")

    @property
    def plan_config(self) -> PlanConfig:
        return PlanConfig(self.block_h, self.block_w, self.gather_segment, self.block_unroll,
                          cluster_cols=self.subtile)

    @property
    def bf16(self) -> bool:
        """True when the variant's kernels read bf16 rows."""
        return "bfloat16" in (self.feat_dtype, self.compute_dtype)

    def kernels(self) -> list[str]:
        """The kernels (wrapper counter names) the variant's SpMM launches,
        its main launch first (the work list's kernel name)."""
        pregather = "spmm_subtile" if self.subtile else "spmm_block"
        return {"pregather": [pregather], "fused": ["spmm_fused"],
                "hybrid": ["spmm_fused", pregather], "int8": ["spmm_int8"],
                "ell": ["spmm_ell"], "weighted": ["spmm_weighted"]}[self.impl]

    def key(self) -> str:
        """The JAX package's key format, so both packages name a variant alike."""
        return (
            f"{self.impl}/h{self.block_h}w{self.block_w}s{self.gather_segment}"
            f"u{self.block_unroll}{'st' if self.subtile else ''}"
            f"{'c' + str(self.stream_chunks) if self.stream_chunks else ''}"
            f"{'/x' + self.feat_dtype if self.feat_dtype else ''}"
            f"/d{self.block_d}/{self.compute_dtype}/{self.precision}/t{self.threshold}"
        )


# --- residency: what a candidate keeps on the card --------------------------

def estimate_residency(v: Variant, num_nodes: int, d: int, nnz: int, lanes: float,
                       chunks: int | None = None) -> float:
    """Device bytes a binary candidate holds while it runs, estimated
    before its plan is built. The port's kernels gather no copy of X, so
    this is the plan (bitmask and hind, `lanes` of them: the deduplicated
    source rows its windows gather, or a coverage plan's covered rows), the
    work list's workspace for the pieces of cut windows (at most one tile
    of block_h x d floats a piece past a window's first: pieces of
    PIECE_BLOCKS blocks or about PIECE_WORK units of work, a unit a set bit
    here, an upper estimate), the float32 features and output, the bf16
    copy of the features of a bf16 variant (2 bytes a value, the JAX
    package's count), and a second output where window chunks are
    concatenated; the workspace is one chunk's (`chunks`, default the
    variant's stream_chunks). A wrong
    estimate costs a candidate, not a result: the race skips one that runs
    out of memory."""
    name = v.kernels()[0]
    h = v.block_h
    plan = lanes * (h / 8 + 4)
    blocks = lanes / v.block_w
    groups = -(-v.plan_config.words_per_col // group_words(name, v.plan_config.words_per_col))
    pieces = blocks / PIECE_BLOCKS[name]
    if PIECE_WORK[name]:
        pieces += nnz / (PIECE_WORK[name] * groups)
    chunks = chunks or v.stream_chunks or 1
    workspace = pieces / chunks * h * d * 4
    features = ((3 if chunks > 1 else 2) * 4 + (2 if v.bf16 else 0)) * num_nodes * d
    return plan + workspace + features


def estimate_lanes(v: Variant, nnz: int, fused_coverage: float | None = None,
                   gather_rows: float | None = None,
                   gather_rows_2048: float | None = None) -> float:
    """The plan lanes `estimate_residency` counts for a binary candidate:
    coverage x nnz for K3 (`fused_coverage`, unknown as 1), nnz at 128-row
    windows, `gather_rows` (the h512 deduplicated source rows) at 512 and
    1024 rows and `gather_rows_2048` at 2048 (each unknown as the one
    before)."""
    if v.impl == "fused":
        return (fused_coverage if fused_coverage is not None else 1.0) * nnz
    r512 = gather_rows if gather_rows is not None else nnz
    r2048 = gather_rows_2048 if gather_rows_2048 is not None else r512
    return nnz if v.block_h <= 128 else (r512 if v.block_h <= 1024 else r2048)


def _device_mem_budget() -> float:
    """Device bytes the tuner may plan a candidate's residency against:
    $VOLTRIX_TORCH_DEVICE_MEM_GB, else 80% of the card's free memory
    (`torch.cuda.mem_get_info`), else 80% of one H100's 80 GB."""
    env = os.environ.get(const.DEVICE_MEM_FLAG, "")
    if env:
        return float(env) * 2**30
    if torch.cuda.is_available():
        return 0.8 * torch.cuda.mem_get_info()[0]
    return 0.8 * 80e9


def _fit(v: Variant, budget: float, residency: dict | None, **stats) -> Variant | None:
    """v if its residency fits `budget`, else its first window-chunked twin
    (2 to 64 chunks, pregather only) that fits, else None; records the
    estimate of what it returns in `residency`."""
    tries = [v]
    if v.impl == "pregather":
        tries += [dataclasses.replace(v, stream_chunks=c) for c in (2, 4, 8, 16, 32, 64)]
    for t in tries:
        est = estimate_residency(t, **stats)
        if est <= budget:
            if residency is not None:
                residency[t.key()] = est
            return t
    return None


def default_space(
    accurate: bool = False,
    d: int | None = None,
    nnz: int | None = None,
    coverage128: float | None = None,
    coverage32: float | None = None,
    gather_rows: int | None = None,
    num_nodes: int | None = None,
    gather_rows_2048: int | None = None,
    device_mem_bytes: float | None = None,
    split_rows8: float | None = None,
    split_slots8: float | None = None,
    residency: dict | None = None,
) -> list[Variant]:
    """The H100's space, the JAX package's `accurate=True` space less the
    TPU gather layouts (ROADMAP.md item 18), in the order path O's races on
    the card ranked them (PERF.md section 6), so that a budget that
    stops the race early drops the least likely winners (on C's graph the
    h128 hybrid's host split alone took 265 s):

    - K3 at 2048 rows / seg 128 / unroll 4 when an h2048 / seg128 coverage
      plan covers at most FUSED_COVERAGE_THRESHOLD rows per nnz
      (`coverage128`; unknown counts as passing), else K3 at seg 32 when
      `coverage32` passes;
    - K1 on PlanConfig(128, 128) (path A's plan, which the JAX space lacks);
    - K2 (column-clustered windows) at 1024 and 2048 rows with unroll 4;
    - K1 at windows of 512, 1024 and 2048 rows with unroll 4;
    - the hybrid at 128 rows / seg 8 (K3 on the dense runs, K1 on the rest);
    - the tall hybrid at 2048 rows / seg 8 / unroll 8, clustered (K3 on the
      dense runs, K2 on the rest), when `density_split_stats(..., 2048, 8)`
      gives rows <= 0.75 and slots <= 1.35, the JAX package's gate.

    accurate=False (the default) adds the JAX package's bf16 variants that
    the port runs, after the float32 ones: K1 on 2048-row windows with
    unroll 4 and K2 on clustered ones, each with feat_dtype="bfloat16",
    and K3's coverage plan at seg 128 with compute_dtype="bfloat16" when
    its gate passes. A compute_dtype variant and its feat_dtype twin run
    the same kernel on the same bf16 rows (the cast is made before the SpMM
    either way), so one of each pair races: the JAX space's own (feat_dtype
    for K1 and K2, compute_dtype for K3). Left out of the JAX space: the TPU gather
    layouts' bf16 twins (packed runs, the interleaved hybrid) and K3's
    slots=3 twin, a TPU pipeline knob. accurate=True keeps the float32
    variants alone. int8 (K8) stays out: it runs 2.0-2.6x slower than torch.sparse.mm on the
    card (PERF.md section 6); `Variant("int8")` races when asked for.

    Past HUGE_BYTES of f32 edge-feature volume (nnz x d x 4) the hybrids
    leave the space, and each other candidate is budgeted by
    `estimate_residency` against `device_mem_bytes` (default
    `_device_mem_budget()`), with lanes of nnz at 128 rows, `gather_rows`
    (the h512 deduplicated rows) at 512 and 1024, `gather_rows_2048` at
    2048 and coverage x nnz for K3: one that does not fit is dropped, and
    a pregather one that fits only in window chunks joins with the fewest
    chunks that fit (stream_chunks). `residency`, a dict, receives each
    kept candidate's estimate by key."""
    space = []
    fused_cov = None
    if coverage128 is None or coverage128 <= FUSED_COVERAGE_THRESHOLD:
        space.append(Variant("fused", block_h=2048, gather_segment=128, block_unroll=4))
        fused_cov = coverage128
    elif coverage32 is not None and coverage32 <= FUSED_COVERAGE_THRESHOLD:
        # 128-row runs waste too much, 32-row runs still cover cheaply
        space.append(Variant("fused", block_h=2048, gather_segment=32, block_unroll=4))
        fused_cov = coverage32
    space += [
        Variant("pregather", block_h=128),
        Variant("pregather", block_h=1024, block_unroll=4, subtile=True),
        Variant("pregather", block_h=2048, block_unroll=4, subtile=True),
        Variant("pregather", block_h=512, block_unroll=4),
        Variant("pregather", block_h=1024, block_unroll=4),
        Variant("pregather", block_h=2048, block_unroll=4),
        Variant("hybrid", block_h=128, gather_segment=8),
    ]
    if (split_rows8 is not None and split_rows8 <= 0.75
            and (split_slots8 if split_slots8 is not None else 99.0) <= 1.35):
        space.append(Variant("hybrid", block_h=2048, gather_segment=8, block_unroll=8,
                             subtile=True))
    if not accurate:
        space += [
            Variant("pregather", block_h=2048, block_unroll=4, feat_dtype="bfloat16"),
            Variant("pregather", block_h=2048, block_unroll=4, subtile=True,
                    feat_dtype="bfloat16"),
        ]
        if coverage128 is None or coverage128 <= FUSED_COVERAGE_THRESHOLD:
            space.append(Variant("fused", block_h=2048, gather_segment=128, block_unroll=4,
                                 compute_dtype="bfloat16"))
    if nnz is None or d is None or nnz * d * 4 <= HUGE_BYTES:
        return space
    budget = device_mem_bytes if device_mem_bytes is not None else _device_mem_budget()
    # the hybrids' host split (numpy, O(nnz log nnz)) took 265 s on C's
    # graph: at this scale they leave the space, as in the JAX package's
    # huge branch
    fitted = [_fit(v, budget, residency, num_nodes=num_nodes or 0, d=d, nnz=nnz,
                   lanes=estimate_lanes(v, nnz, fused_cov, gather_rows, gather_rows_2048))
              for v in space if v.impl != "hybrid"]
    return [v for v in fitted if v is not None]


def weighted_default_space(
    d: int | None = None,
    nnz: int | None = None,
    accurate: bool = False,
    dense_slots_per_nnz: float | None = None,
    num_nodes: int | None = None,
    device_mem_bytes: float | None = None,
) -> list[Variant]:
    """The weighted space: K6 (edge-per-lane ELL plans, O(nnz) plan bytes)
    at windows of 128, 256 and 512 rows with unroll 4, and K4 (the dense
    value-plane kernel) at 128 rows when its plane stays within 8 float32
    slots an edge (`dense_slots_per_nnz`, the h128 plan's slots per edge:
    `coverage_expansion(..., 128, 1) * 128`), the JAX package's gate.
    Past HUGE_BYTES of edge-feature volume K4 leaves the space, and K6
    runs in the fewest window chunks (2 to 64) whose estimated residency
    (12 bytes a lane, workspace of row pieces, features and output) fits
    the device budget, when the whole plan does not. accurate=False (the
    default) adds the JAX package's bf16 twins of K6 at 128 and 256 rows
    (feat_dtype="bfloat16"), chunked as the others past HUGE_BYTES."""
    space = [Variant("ell", block_h=h, block_unroll=4) for h in (128, 256, 512)]
    if not accurate:
        space += [Variant("ell", block_h=h, block_unroll=4, feat_dtype="bfloat16")
                  for h in (128, 256)]
    huge = nnz is not None and d is not None and nnz * d * 4 > HUGE_BYTES
    if not huge:
        if dense_slots_per_nnz is not None and dense_slots_per_nnz <= 8.0:
            space.append(Variant("weighted", block_h=128))
        return space
    budget = device_mem_bytes if device_mem_bytes is not None else _device_mem_budget()
    lanes = nnz * 1.05
    fixed = 2 * (num_nodes or 0) * d * 4 + lanes * 12
    from ..ops.ell import PIECE_LANES

    workspace = lanes / PIECE_LANES * d * 4
    if fixed + workspace <= budget:
        return space
    for c in (2, 4, 8, 16, 32, 64):
        if fixed + (num_nodes or 0) * d * 4 + workspace / c <= budget:
            return [dataclasses.replace(v, stream_chunks=c) for v in space]
    return []


# --- plans and runs --------------------------------------------------------

@dataclass
class TunedSpmm:
    """The best (plan, kernel, ordering) for one matrix; call it like `spmm`.

    When an ordering other than "identity" won, `perm` / `inv_perm` (int64
    tensors on the plan's device) hold the row permutation and `__call__`
    applies it: out = spmm(A_perm, x[perm])[inv_perm]. `plan_seconds` and
    `errors` hold each candidate's plan build seconds and, for a skipped
    one, why; `residency` the default space's estimated bytes of each kept
    candidate past HUGE_BYTES; `peak_bytes` each timed candidate's measured
    device peak on the card (plan, work list, workspace, features and
    output: `torch.cuda.max_memory_allocated` over its first call);
    `variants` each candidate's key -> (ordering, Variant)."""

    plan: object
    variant: Variant
    time_ms: float
    candidates: dict = field(default_factory=dict)
    ordering: str = "identity"
    perm: torch.Tensor | None = None
    inv_perm: torch.Tensor | None = None
    plan_seconds: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)
    residency: dict = field(default_factory=dict)
    peak_bytes: dict = field(default_factory=dict)
    variants: dict = field(default_factory=dict)

    def __call__(self, feat: torch.Tensor) -> torch.Tensor:
        return _run_variant(self.variant, self.plan, feat, self.perm, self.inv_perm)


def _reorder(name: str, indptr, indices, num_nodes: int, values=None):
    """(indptr2, indices2, values2 | None, perm | None) for a named ordering;
    per-edge values ride along through the permutation."""
    if name == "identity":
        return indptr, indices, values, None
    import scipy.sparse as sp

    from ..data.generate import reorder_degree, reorder_rcm

    fns = {"rcm": reorder_rcm, "degree": reorder_degree}
    if name not in fns:
        raise ValueError(f"unknown ordering {name!r}: 'identity', 'rcm' or 'degree'")
    data = (np.ones(np.asarray(indices).shape[0], np.float32) if values is None
            else np.asarray(values, np.float32))
    a = sp.csr_matrix((data, np.asarray(indices), np.asarray(indptr)),
                      shape=(num_nodes, num_nodes))
    a2, perm = fns[name](a)
    vals2 = None if values is None else a2.data
    return a2.indptr, a2.indices, vals2, np.asarray(perm, np.int32)


def _perm_tensors(perm, device):
    """(perm, inv_perm) as int64 tensors on `device`, or (None, None)."""
    if perm is None:
        return None, None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return (torch.from_numpy(perm.astype(np.int64)).to(device),
            torch.from_numpy(inv.astype(np.int64)).to(device))


def _variant_plan_key(variant: Variant):
    """Variants that differ only in how the plan runs share one built plan."""
    cfg = variant.plan_config
    if variant.impl == "ell":
        return ("ell", cfg, variant.stream_chunks)
    if variant.impl == "weighted":
        return ("weighted", cfg)
    if variant.impl == "hybrid":
        return ("hybrid", cfg, variant.threshold)
    if variant.stream_chunks:
        return (cfg, variant.stream_chunks)
    return (cfg,)


def build_variant_plan(variant: Variant, indptr, indices, num_nodes: int, values,
                       backend: str = "auto", weighted: bool | None = None, device="cuda"):
    """This variant's plan on `device` (a list of window chunks for
    stream_chunks). Shared by the tuner and its probe (tuner/probe.py)."""
    cfg = variant.plan_config
    if weighted is None:
        weighted = values is not None
    if weighted and variant.impl not in ("ell", "weighted"):
        # a binary variant would race (and win with) the wrong product
        raise ValueError(f"variant {variant.key()} is binary; weighted tuning "
                         "accepts impl='ell' or impl='weighted' only")
    if variant.impl == "ell":
        from ..format.ell import csr_preprocess_ell, slice_ell_windows

        base = csr_preprocess_ell(indptr, indices, num_nodes, cfg, values=values)
        if variant.stream_chunks:
            return [s.to(device) for s in slice_ell_windows(base, variant.stream_chunks)]
        return base.to(device)
    if variant.impl == "weighted":
        return csr_preprocess(indptr, indices, num_nodes, cfg, values=values).to(device)
    if variant.impl == "hybrid":
        from ..format.hybrid import csr_preprocess_hybrid

        return csr_preprocess_hybrid(indptr, indices, num_nodes, dense_config=cfg,
                                     threshold=variant.threshold, backend=backend).to(device)
    base = csr_preprocess(indptr, indices, num_nodes, cfg, backend=backend)
    if variant.stream_chunks:
        from ..format.stream import slice_plan_windows

        return [s.to(device) for s in slice_plan_windows(base, variant.stream_chunks)]
    return base.to(device)


def _run_variant(variant: Variant, plan, feat: torch.Tensor, perm=None, inv_perm=None):
    """A @ feat through the variant's kernel on `plan` (rows permuted in and
    out when `perm` is given), in the caller's dtype: a bf16 variant's
    float32 sums are cast to it once, not rounded through bf16 first."""
    from ..ops import spmm, spmm_ell_streamed

    out_dtype = feat.dtype
    if variant.feat_dtype is not None:
        feat = feat.to(getattr(torch, variant.feat_dtype))
    if perm is not None:
        feat = feat.index_select(0, perm)
    impl = variant.impl
    kw = dict(out_dtype=out_dtype, compute_dtype=getattr(torch, variant.compute_dtype))
    if impl == "ell" and variant.stream_chunks:
        out = spmm_ell_streamed(plan, feat, **kw)
    elif impl == "hybrid":
        out = spmm(plan, feat, subtile=variant.subtile, **kw)
    elif impl in ("fused", "ell"):
        out = spmm(plan, feat, impl=impl, **kw)
    elif impl in ("int8", "weighted"):
        # no compute_dtype (the Variant refuses it), but the caller's dtype:
        # the JAX package's _run_variant gives K4 and K8 no out_dtype, so its
        # bf16 variants round their float32 sums through bf16 before the
        # cast back (ROADMAP.md §3, Faults of the JAX package)
        out = spmm(plan, feat, impl=impl, out_dtype=out_dtype)
    else:  # K1 or K2, on the whole plan or its window chunks
        out = spmm(plan, feat, impl="pregather", subtile=variant.subtile, **kw)
    if inv_perm is not None:
        out = out.index_select(0, inv_perm)
    return out.to(out_dtype)


def _loaders(variant: Variant) -> list:
    """The library loaders (nvcc builds) of the kernels the variant launches."""
    from ..ops import block_spmm, ell, fused_spmm, quant, subtile_spmm, weighted

    loader = {"spmm_block": block_spmm, "spmm_subtile": subtile_spmm, "spmm_fused": fused_spmm,
              "spmm_int8": quant, "spmm_ell": ell, "spmm_weighted": weighted}
    return [loader[k].load_library for k in variant.kernels()]


# --- cache identity --------------------------------------------------------

_SAMPLE = 8192
_warned_no_tag = False


def _matrix_hash(indptr, indices, num_nodes: int) -> str:
    """Strided-sample md5 of the CSR (O(1) work in nnz), the JAX package's
    scheme digest for digest. A collision can only pick a worse cached
    variant: the plan is always rebuilt from the actual matrix. Callers who
    want no hashing pass `hash_tag`."""
    md5 = hashlib.md5()
    md5.update(np.asarray([num_nodes, len(indptr), len(indices)], dtype=np.int64).tobytes())
    for arr in (indptr, indices):
        arr = np.ascontiguousarray(arr)
        step = max(1, arr.shape[0] // _SAMPLE)
        md5.update(arr[::step][:_SAMPLE].tobytes())
        md5.update(arr[-16:].tobytes())
    return md5.hexdigest()[:16]


def _values_hash(values) -> str:
    """Strided-sample md5 of the per-edge values (the `_matrix_hash` scheme),
    for the memory cache only: a cached TunedSpmm holds its value plane."""
    values = np.ascontiguousarray(values)
    md5 = hashlib.md5()
    md5.update(np.int64(values.shape[0]).tobytes())
    step = max(1, values.shape[0] // _SAMPLE)
    md5.update(values[::step][:_SAMPLE].tobytes())
    md5.update(values[-16:].tobytes())
    return md5.hexdigest()[:16]


_CODE_VERSION = None


def _code_files() -> list[str]:
    """What the code version hashes: the .py files of ops/, format/ and
    tuner/, and csrc's .cu, .cuh and .hpp sources (on the card the kernels
    are built from them), in a fixed order."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = []
    for rel, suffixes in (("ops", (".py",)), ("format", (".py",)), ("tuner", (".py",)),
                          ("csrc", (".cu", ".cuh", ".hpp"))):
        d = os.path.join(root, rel)
        files += [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(suffixes)]
    return files


def _code_version() -> str:
    """md5 of `_code_files()`, pinned at the first call for the life of the
    process: a long tune whose sources are edited on disk keeps writing
    entries under the hash of the code it runs."""
    global _CODE_VERSION
    if _CODE_VERSION is None:
        md5 = hashlib.md5()
        for path in _code_files():
            with open(path, "rb") as f:
                md5.update(f.read())
        _CODE_VERSION = md5.hexdigest()[:12]
    return _CODE_VERSION


def _device_tag(device: torch.device) -> str:
    """The cache's device identity: the CPU (plain versions), or the card's name."""
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    return f"cuda-{hashlib.md5(name.encode()).hexdigest()[:6]}"


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _device_reachable(timeout_s: float = 90.0) -> bool:
    """True when a fresh subprocess runs one small CUDA op: after a probe
    timed out twice, tells a card that is gone (keep the candidate out of the
    resume file, to time it later) from a candidate that hangs (persist inf)."""
    import subprocess
    import sys

    code = ("import torch; x = torch.ones(8, 128, device='cuda'); "
            "print('reachable', float((x @ x.T).sum()))")
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return r.returncode == 0 and "reachable" in (r.stdout or "")


def candidate_invalid(err: BaseException) -> bool:
    """True for the failures that make a candidate invalid (skipped): the
    kernels' and plan builders' refusals (ValueError) and running out of
    device memory. Anything else stops the race."""
    return isinstance(err, (ValueError, torch.cuda.OutOfMemoryError))


# --- the tuner -------------------------------------------------------------

class Tuner:
    """What the SpMM and the attention tuner share: a memory cache, the
    disk cache's directory (the caller's `cache_dir`, else
    $VOLTRIX_TORCH_CACHE_DIR, else ~/.voltrix_spmm_tpu_torch/cache), the
    soft budget's default ($VOLTRIX_TORCH_TUNE_BUDGET_S) and the lines
    printed under $VOLTRIX_TORCH_PRINT_AUTO_TUNE."""

    file_prefix = "tune"

    def __init__(self, cache_dir: str | None = None):
        self._mem: dict = {}
        self._cache_dir = cache_dir

    def cache_dir(self) -> str:
        if self._cache_dir is not None:
            return self._cache_dir
        return os.environ.get(
            const.CACHE_DIR_FLAG,
            os.path.join(os.path.expanduser("~"), ".voltrix_spmm_tpu_torch", "cache"))

    def _disk_path(self, signature: str) -> str:
        return os.path.join(self.cache_dir(), f"{self.file_prefix}.{signature}.json")

    @staticmethod
    def _budget(budget_s: float | None) -> float | None:
        if budget_s is None:
            env = os.environ.get(const.TUNE_BUDGET_FLAG, "")
            budget_s = float(env) if env else None
        return budget_s

    def _say(self, msg: str) -> None:
        if env_flag(const.PRINT_AUTOTUNE_FLAG):
            print(f"voltrix_torch {self.file_prefix}: {msg}")


class SpmmTuner(Tuner):

    def compile_and_tune(
        self,
        indptr,
        indices,
        num_nodes: int,
        feat,
        space: list[Variant] | None = None,
        hash_tag: str | None = None,
        iters: int = 8,
        backend: str = "auto",
        reorderings: tuple[str, ...] = ("identity",),
        budget_s: float | None = None,
        parallel_compile: bool = False,
        values=None,
        isolate: bool | None = None,
        probe_timeout_s: float = 900.0,
        device="cuda",
        accurate: bool = False,
    ) -> TunedSpmm:
        """The fastest (variant, ordering) for this (matrix, feature shape)
        on `device` (the card unless the caller asks for the CPU).

        feat: representative features (its shape and dtype matter; a numpy
        array or a tensor). reorderings: orderings raced by measured time; a
        non-identity winner permutes rows inside the returned TunedSpmm.
        values: per-edge weights; the space then holds the weighted kernels
        (K4, K6), binary variants are invalid, plans carry the values through
        any reordering, and the signature gets a ".w". budget_s: soft budget
        in seconds (default $VOLTRIX_TORCH_TUNE_BUDGET_S): past it the
        remaining candidates are skipped and the best so far wins.
        parallel_compile: build the candidates' plans on the host in four
        threads while earlier ones are timed, once for variants that share
        a plan (`_variant_plan_key`). isolate: time each candidate
        in a subprocess of its own (tuner/probe.py), by default past
        HUGE_BYTES of f32 edge-feature volume (nnz x d x 4): a process's exit
        frees all it held. Plan build seconds are recorded, not raced; the
        first calls of each candidate, outside the timed window, build its
        work list and kernels. accurate=True races the float32 variants
        of the default space alone (`default_space`); its signature gets an
        "A", as tune_attention's does."""
        device = torch.device(device)
        budget_s = self._budget(budget_s)
        if hash_tag is None and len(indices) >= 1 << 20:
            global _warned_no_tag
            if not _warned_no_tag:
                _warned_no_tag = True
                logging.getLogger("voltrix_torch").warning(
                    "tune_spmm: no hash_tag given for a %d-nnz matrix; falling back to a "
                    "sampled content hash. Pass hash_tag= for exact cache identity.",
                    len(indices))
        tag = hash_tag or _matrix_hash(indptr, indices, num_nodes)
        d = int(feat.shape[1])
        wmark = ".w" if values is not None else ""
        # an explicit space is part of the identity: a caller who adds
        # candidates must see them race. The default space is not hashed (it
        # is built only on a miss); _code_version covers changes to it.
        smark = ""
        if space is not None:
            smark = ".s" + hashlib.md5("|".join(sorted(v.key() for v in space)).encode()
                                       ).hexdigest()[:8]
        amark = "A" if accurate and space is None else ""
        signature = (f"{tag}.n{num_nodes}.d{d}.{_dtype_name(feat.dtype)}.{_device_tag(device)}"
                     f"{wmark}{smark}{amark}.{_code_version()}")
        # the disk entry is structure only (plans are rebuilt from the
        # caller's values); a memory entry holds its value plane
        mem_key = signature if values is None else f"{signature}.v{_values_hash(values)}"
        if mem_key in self._mem:
            self._say(f"memory hit for {signature}")
            return self._mem[mem_key]

        csrs: dict = {"identity": (indptr, indices, values, None)}

        def csr_for(ordering: str):
            if ordering not in csrs:
                csrs[ordering] = _reorder(ordering, indptr, indices, num_nodes, values)
            return csrs[ordering]

        def build(variant: Variant, ordering: str, on=device):
            ptr, idx, vals, _ = csr_for(ordering)
            return build_variant_plan(variant, ptr, idx, num_nodes, vals, backend,
                                      weighted=values is not None, device=on)

        def tuned_from(variant, ordering, time_ms, **record):
            perm, inv_perm = _perm_tensors(csr_for(ordering)[3], device)
            return TunedSpmm(plan=build(variant, ordering), variant=variant, time_ms=time_ms,
                             ordering=ordering, perm=perm, inv_perm=inv_perm, **record)

        disk = self._disk_path(signature)
        if os.path.exists(disk):
            with open(disk) as f:
                entry = json.load(f)
            tuned = tuned_from(
                Variant(**entry["variant"]), entry.get("ordering", "identity"), entry["time_ms"],
                **{k: entry.get(k, {}) for k in ("candidates", "plan_seconds", "errors",
                                                 "residency", "peak_bytes")},
                variants={k: (o, Variant(**v)) for k, (o, v) in entry.get("variants", {}).items()})
            self._mem[mem_key] = tuned
            self._say(f"disk hit for {signature}: {tuned.variant.key()}")
            return tuned

        residency: dict = {}
        if space is None:
            space = _default_space_for(indptr, indices, num_nodes, d, values, residency,
                                       accurate)
            for k, b in residency.items():
                self._say(f"{k} residency estimate {b / 2**30:.3f} GiB")
        if isolate is None:
            isolate = len(indices) * d * 4 > HUGE_BYTES
        candidates = [(f"{o}|{v.key()}", v, o) for o in reorderings for v in space]
        results: dict[str, float] = {}
        plan_s: dict[str, float] = {}
        errors: dict[str, str] = {}
        peaks: dict[str, int] = {}
        best = None  # (ms, variant, ordering)

        # a race cut short resumes: each candidate's time is kept in a
        # .partial file as it lands (timeouts excepted) and trusted here
        partial = disk + ".partial"
        timeout_keys: set[str] = set()

        def save_partial():
            os.makedirs(self.cache_dir(), exist_ok=True)
            tmp = partial + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"results": {k: v for k, v in results.items()
                                       if k not in timeout_keys}}, f)
            os.replace(tmp, partial)

        if os.path.exists(partial):
            try:
                with open(partial) as f:
                    prior = json.load(f).get("results", {})
            except ValueError:
                prior = {}
            for key, variant, ordering in candidates:
                if key in prior:
                    results[key] = t = float(prior[key])
                    if t != math.inf and (best is None or t < best[0]):
                        best = (t, variant, ordering)
            if results:
                self._say(f"resumed {len(results)} candidate time(s) from a partial race")

        def record(key, variant, ordering, t, err=None):
            nonlocal best
            results[key] = t
            if err:
                errors[key] = err
            save_partial()
            self._say(f"{key} -> {t:.4f} ms" + (f" ({err})" if err else "")
                      + (f", plan {plan_s[key]:.3f} s" if key in plan_s else "")
                      + (f", peak {peaks[key] / 2**30:.3f} GiB" if key in peaks else ""))
            if t != math.inf and (best is None or t < best[0]):
                best = (t, variant, ordering)

        probe_csr = None
        pool = None
        futures: dict = {}
        t_begin = time.perf_counter()
        try:
            if isolate and device.type == "cuda":
                # the probes reuse build/kernels; build there first, once
                for loader in {ld for _, v, _ in candidates for ld in _loaders(v)}:
                    loader()
            if isolate:
                import tempfile

                with tempfile.NamedTemporaryFile(prefix="voltrix_probe_csr_", suffix=".npz",
                                                 delete=False) as f:
                    arrs = {"indptr": np.asarray(indptr), "indices": np.asarray(indices)}
                    if values is not None:
                        arrs["values"] = np.asarray(values, np.float32)
                    np.savez(f, **arrs)
                    probe_csr = f.name
            x = None
            base_bytes = 0
            if not isolate:
                x = (feat if isinstance(feat, torch.Tensor) else torch.from_numpy(np.asarray(feat)))
                x = x.to(device).contiguous()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    base_bytes = torch.cuda.memory_allocated(device)
                if parallel_compile:
                    from concurrent.futures import ThreadPoolExecutor

                    for o in reorderings:  # once, before the threads read them
                        csr_for(o)
                    pool = ThreadPoolExecutor(max_workers=4)
                    for key, variant, ordering in candidates:
                        pk = (ordering,) + _variant_plan_key(variant)
                        if key not in results and pk not in futures:  # one build a plan
                            futures[pk] = pool.submit(_timed, build, variant, ordering, "cpu")
            skipped = 0
            for key, variant, ordering in candidates:
                if key in results:  # resumed
                    continue
                if (budget_s is not None and best is not None
                        and time.perf_counter() - t_begin > budget_s):
                    skipped += 1
                    continue
                if isolate:
                    out = _probe(probe_csr, num_nodes, d, _dtype_name(feat.dtype), variant,
                                 ordering, iters, backend, device, probe_timeout_s)
                    if out.get("timeout"):  # a blip and a hang look alike once
                        out = _probe(probe_csr, num_nodes, d, _dtype_name(feat.dtype), variant,
                                     ordering, iters, backend, device, probe_timeout_s)
                        if out.get("timeout") and not (device.type == "cuda"
                                                       and _device_reachable()):
                            timeout_keys.add(key)
                    if "plan_s" in out:
                        plan_s[key] = out["plan_s"]
                    if "peak_bytes" in out:
                        peaks[key] = out["peak_bytes"]
                    if out.get("ok"):
                        record(key, variant, ordering, float(out["time_ms"]))
                    elif out.get("invalid") or out.get("timeout"):
                        record(key, variant, ordering, math.inf, out["error"])
                    else:
                        raise RuntimeError(f"tune_spmm: candidate {key} failed in its probe; "
                                           f"the race stops: {out['error']}")
                    continue
                try:
                    pk = (ordering,) + _variant_plan_key(variant)
                    if pk in futures:
                        host_plan, plan_s[key] = futures[pk].result()
                        plan = _to(host_plan, device)
                    else:
                        plan, plan_s[key] = _timed(build, variant, ordering)
                    perm, inv_perm = _perm_tensors(csr_for(ordering)[3], device)

                    def run(p=plan, pe=perm, ip=inv_perm, v=variant):
                        return _run_variant(v, p, x, pe, ip)

                    peak = peak_bytes(run, device)
                    if peak is not None:  # the features are part of the residency
                        peaks[key] = peak - base_bytes + x.nbytes
                    t = _bench(run, device, iters)
                except Exception as e:
                    if not candidate_invalid(e):
                        raise RuntimeError(f"tune_spmm: candidate {key} failed; the race stops: "
                                           f"{type(e).__name__}: {e}") from e
                    t, err = math.inf, f"{type(e).__name__}: {e}"
                else:
                    err = None
                plan = run = perm = inv_perm = None
                _release(device, base_bytes, key)
                record(key, variant, ordering, t, err)
            if skipped:
                self._say(f"budget {budget_s:.1f} s spent, skipped {skipped} candidate(s)")
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
            if probe_csr is not None:
                try:
                    os.unlink(probe_csr)
                except OSError:
                    pass

        if best is None:
            raise RuntimeError(f"no valid tuning candidate: {errors or results}")
        variants = {key: (o, v) for key, v, o in candidates if key in results}
        tuned = tuned_from(best[1], best[2], best[0], candidates=results, plan_seconds=plan_s,
                           errors=errors, residency=residency, peak_bytes=peaks,
                           variants=variants)
        self._mem[mem_key] = tuned
        os.makedirs(self.cache_dir(), exist_ok=True)
        tmp = disk + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"variant": dataclasses.asdict(best[1]), "ordering": best[2],
                       "time_ms": best[0], "candidates": results, "plan_seconds": plan_s,
                       "errors": errors, "residency": residency, "peak_bytes": peaks,
                       "variants": {k: (o, dataclasses.asdict(v))
                                    for k, (o, v) in variants.items()}}, f, indent=2)
        os.replace(tmp, disk)
        try:  # the race finished: its resume file is spent
            os.unlink(partial)
        except OSError:
            pass
        self._say(f"best for {signature}: {best[1].key()} ({best[2]}) @ {best[0]:.4f} ms")
        return tuned


def _default_space_for(indptr, indices, num_nodes: int, d: int, values, residency: dict,
                       accurate: bool = False):
    """The default space from the graph's statistics: O(nnz log nnz) host
    passes, run only on a cache miss."""
    from ..format.preprocess import coverage_expansion, density_split_stats

    nnz = len(indices)
    if values is not None:
        slots = coverage_expansion(indptr, indices, num_nodes, 128, 1) * 128
        return weighted_default_space(d=d, nnz=nnz, accurate=accurate,
                                      dense_slots_per_nnz=slots, num_nodes=num_nodes)
    cov128 = coverage_expansion(indptr, indices, num_nodes, 2048, 128)
    cov32 = (coverage_expansion(indptr, indices, num_nodes, 2048, 32)
             if cov128 > FUSED_COVERAGE_THRESHOLD else None)
    sr8, ss8 = density_split_stats(indptr, indices, num_nodes, 2048, 8)
    rows512 = rows2048 = None
    if nnz * d * 4 > HUGE_BYTES:  # only the residency budget reads them
        rows512 = int(coverage_expansion(indptr, indices, num_nodes, 512, 1) * nnz)
        rows2048 = int(coverage_expansion(indptr, indices, num_nodes, 2048, 1) * nnz)
    return default_space(accurate, d=d, nnz=nnz, coverage128=cov128, coverage32=cov32,
                         gather_rows=rows512, num_nodes=num_nodes, gather_rows_2048=rows2048,
                         split_rows8=sr8, split_slots8=ss8, residency=residency)


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _to(plan, device):
    return [p.to(device) for p in plan] if isinstance(plan, list) else plan.to(device)


def peak_bytes(fn, device: torch.device) -> int | None:
    """The card's allocated-byte peak over one call of fn(), what was
    allocated before it included (None on the CPU). A candidate's first
    call also builds its work list, which stays beside the plan."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def _bench(fn, device: torch.device, iters: int) -> float:
    """ms a call of fn(): `gpu_bench` on the card, `CPU_bench` on the CPU."""
    if device.type == "cuda":
        return gpu_bench(fn, iters=iters, warmup=2, device=device)
    return CPU_bench(fn, iters=iters, warmup=1)


def _release(device: torch.device, base_bytes: int, key: str) -> None:
    """After a candidate's plan, work lists and outputs are dropped: return
    the cached blocks to the card and check that the allocated bytes are
    back at their level before the race."""
    if device.type != "cuda":
        return
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(device) - base_bytes
    if held > 0:
        raise RuntimeError(f"the tuner: {held} bytes stay allocated on the card after "
                           f"candidate {key} was freed")


def _probe(csr_path, num_nodes, d, dtype_name, variant, ordering, iters, backend, device,
           timeout_s) -> dict:
    """One isolated probe (tuner/probe.py): its JSON line, or
    {"timeout": True, "error": ...}."""
    import subprocess
    import sys
    import tempfile

    # feat_dtype: the caller's features, which the variant's own feat_dtype
    # (in its fields) casts as in process
    spec = {"csr": csr_path, "num_nodes": num_nodes, "d": d, "feat_dtype": dtype_name,
            "variant": dataclasses.asdict(variant), "ordering": ordering, "iters": iters,
            "backend": backend, "device": str(device)}
    with tempfile.NamedTemporaryFile("w", prefix="voltrix_probe_", suffix=".json",
                                     delete=False) as sf:
        json.dump(spec, sf)
    env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable, "-m", "voltrix_spmm_tpu_torch.tuner.probe", sf.name],
                           capture_output=True, text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"ok": False, "timeout": True, "error": f"timeout after {timeout_s:.0f} s"}
    finally:
        os.unlink(sf.name)
    for line in reversed((r.stdout or "").strip().splitlines()):
        if line.strip().startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return {"ok": False, "error": (r.stderr or "no output")[-600:]}


# the module's tuner (the reference exposes a singleton `jit_tuner`)
spmm_tuner = SpmmTuner()


def tune_spmm(indptr, indices, num_nodes: int, feat, **kwargs) -> TunedSpmm:
    return spmm_tuner.compile_and_tune(indptr, indices, num_nodes, feat, **kwargs)

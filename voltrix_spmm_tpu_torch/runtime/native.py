"""The native C++/OpenMP plan preprocess, through ctypes (counterpart of
voltrix_spmm_tpu/runtime/native.py).

The two-pass plan construction, the column clustering and a host SpMM
oracle of csrc/voltrix_preprocess.hpp, built with g++ at first use
(jit/compiler.py:build_host) and called on numpy arrays. The plans it
builds are the numpy path's (format/preprocess.py) bit for bit, wrapped
in CPU tensors the same way. `native_available()` tells
`csr_preprocess(backend="auto")` whether the build succeeds; a build
asked for outright (backend="native") raises when it fails.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os

import numpy as np
import torch

from ..format.cluster import _bits_np, _host
from ..format.plan import PlanConfig, SpmmPlan
from ..project import const

logger = logging.getLogger("voltrix_torch")

_INCLUDES = ('"voltrix_preprocess.hpp"',)

_ANALYZE_ARGS = (
    ("indptr", np.int32),
    ("indices", np.int32),
    ("num_nodes", int),
    ("window_rows", int),
    ("seg", int),
    ("uniq_cols", np.int32),
    ("win_unique", np.int32),
)

_ANALYZE_BODY = """
    __return_code = voltrix_torch::analyze_windows(
        indptr, indices, num_nodes, window_rows, seg, uniq_cols, win_unique);
"""

_FILL_ARGS = (
    ("indptr", np.int32),
    ("indices", np.int32),
    ("num_nodes", int),
    ("window_rows", int),
    ("block_cols", int),
    ("seg", int),
    ("uniq_cols", np.int32),
    ("win_unique", np.int32),
    ("block_ptr", np.int64),
    ("hind", np.int32),
    ("bitmask", np.uint32),
    ("words", int),
    ("nnz_out", np.int64),
)

_FILL_BODY = """
    __return_code = voltrix_torch::fill_plan(
        indptr, indices, num_nodes, window_rows, block_cols, seg, uniq_cols,
        win_unique, block_ptr, hind, bitmask, words, nnz_out);
"""

_CLUSTER_ARGS = (
    ("num_windows", int),
    ("words", int),
    ("block_cols", int),
    ("seg", int),
    ("block_ptr", np.int64),
    ("hind", np.int32),
    ("bitmask", np.uint32),
    ("occ", np.int32),
)

_CLUSTER_BODY = """
    __return_code = voltrix_torch::cluster_windows(
        num_windows, words, block_cols, seg, block_ptr, hind, bitmask, occ);
"""

_ORACLE_ARGS = (
    ("indptr", np.int32),
    ("indices", np.int32),
    ("num_rows", int),
    ("x", np.float32),
    ("d", int),
    ("out", np.float32),
)

_ORACLE_BODY = """
    __return_code = voltrix_torch::csr_spmm_f32(
        indptr, indices, num_rows, x, d, out);
"""


@functools.cache
def _build(name: str):
    from ..jit import build_host, generate

    args, body = {
        "preprocess_analyze": (_ANALYZE_ARGS, _ANALYZE_BODY),
        "preprocess_fill": (_FILL_ARGS, _FILL_BODY),
        "preprocess_cluster": (_CLUSTER_ARGS, _CLUSTER_BODY),
        "csr_spmm_oracle": (_ORACLE_ARGS, _ORACLE_BODY),
    }[name]
    return build_host(name, args, generate(_INCLUDES, args, body))


def _call(name: str, *args) -> None:
    rc = _build(name)(*args)
    if rc != 0:
        raise RuntimeError(f"native {name} failed with code {rc}")


def build_libraries() -> None:
    """Build (or reuse) every host library of this module; raise if one
    does not build."""
    for name in ("preprocess_analyze", "preprocess_fill", "preprocess_cluster",
                 "csr_spmm_oracle"):
        _build(name)


def native_available() -> bool:
    """True when the native preprocess builds (and is not disabled by
    VOLTRIX_TORCH_DISABLE_NATIVE=1); a failed build is logged."""
    if os.environ.get(const.DISABLE_NATIVE_FLAG, "0") == "1":
        return False
    try:
        _build("preprocess_analyze")
        _build("preprocess_fill")
        return True
    except Exception as e:  # no compiler or a failed build: "auto" takes numpy
        logger.warning("native preprocessing unavailable: %s", e)
        return False


def native_spmm_oracle(indptr, indices, num_nodes: int, feat) -> np.ndarray:
    """Host C++/OpenMP CSR @ feat (binary values) in float32, in CSR order.
    Expects a canonical CSR: duplicate entries sum, where the binarizing
    scipy oracle (`ops.spmm_scipy`) counts them once."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    feat = np.ascontiguousarray(_host(feat), np.float32)
    out = np.zeros((num_nodes, feat.shape[1]), np.float32)
    _call("csr_spmm_oracle", indptr, indices, num_nodes, feat, feat.shape[1], out)
    return out


def native_preprocess(indptr, indices, num_nodes: int, config: PlanConfig,
                      num_cols: int | None = None) -> SpmmPlan:
    """The plan of a binary CSR from the native preprocess: the numpy path's
    plan bit for bit (CPU tensors). Inputs past the int32 range that the
    native preprocess indexes with go to the numpy path, with a warning."""
    from ..format.preprocess import _numpy_preprocess, _plan, pad_empty_windows

    W, K, words = config.block_h, config.block_w, config.words_per_col
    num_windows = max(-(-num_nodes // W), 1)

    # the native code indexes with int32: a >= 2^31 nnz or id space would wrap
    # after the cast, so such inputs take the numpy path, int64 throughout
    indptr64 = np.asarray(indptr, dtype=np.int64)
    span = num_cols if num_cols is not None else num_nodes
    i32max = np.iinfo(np.int32).max
    nnz64 = int(indptr64[-1]) if indptr64.shape[0] else 0
    if nnz64 > i32max or num_nodes > i32max or span > i32max:
        logger.warning(
            "native preprocessing: input exceeds int32 range (nnz=%s, num_nodes=%s, "
            "span=%s); using the numpy backend", nnz64, num_nodes, span,
        )
        return _numpy_preprocess(indptr64, np.asarray(indices, np.int64), num_nodes, config,
                                 num_cols)

    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if indptr.shape[0] != num_nodes + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries, want {num_nodes + 1}")
    common = dict(config=config, num_nodes=num_nodes, num_cols=num_cols)
    if indices.shape[0] == 0:
        return _plan(
            bitmask=np.zeros((0, words, K), np.uint32),
            hind=np.zeros((0, K), np.int32),
            window_of_block=np.zeros((0,), np.int32),
            block_ptr=np.zeros((num_windows + 1,), np.int32),
            num_edges=0, has_empty_windows=True, **common,
        )

    seg = config.gather_segment
    uniq_cols = np.empty(indices.shape[0], dtype=np.int32)
    win_unique = np.zeros(num_windows, dtype=np.int32)
    _call("preprocess_analyze", indptr, indices, num_nodes, W, seg, uniq_cols, win_unique)

    blocks_per_window = -(-(win_unique.astype(np.int64) * seg) // K)
    if config.block_unroll > 1:
        u = config.block_unroll
        blocks_per_window = -(-blocks_per_window // u) * u
    blocks_per_window = pad_empty_windows(blocks_per_window, config.block_unroll)
    block_ptr = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(blocks_per_window, out=block_ptr[1:])
    total_blocks = int(block_ptr[-1])

    hind = np.zeros((total_blocks, K), dtype=np.int32)
    bitmask = np.zeros((total_blocks, words, K), dtype=np.uint32)
    nnz_out = np.zeros(1, dtype=np.int64)
    _call("preprocess_fill", indptr, indices, num_nodes, W, K, seg, uniq_cols, win_unique,
          block_ptr, hind.reshape(-1), bitmask.reshape(-1), words, nnz_out)
    return _plan(
        bitmask=bitmask,
        hind=hind,
        window_of_block=np.repeat(np.arange(num_windows, dtype=np.int32), blocks_per_window),
        block_ptr=block_ptr,
        num_edges=int(nnz_out[0]),
        has_empty_windows=bool((blocks_per_window == 0).any()),
        **common,
    )


def native_cluster(plan: SpmmPlan) -> SpmmPlan:
    """The C++/OpenMP twin of `format.cluster.cluster_window_columns` with
    `block_occupancy`, in one window-local pass: the same plan and occ bit
    for bit. The caller's plan is left as it was."""
    cfg = plan.config
    if cfg.block_h % 128:
        raise ValueError(f"clustering needs block_h % 128 == 0, got {cfg.block_h}")
    if plan.total_blocks == 0:
        return dataclasses.replace(plan, occ=torch.zeros(0, dtype=torch.int32))
    # the pass permutes lanes in place: work on copies
    bm = np.array(_bits_np(plan.bitmask), copy=True)
    hind = np.array(_host(plan.hind), dtype=np.int32, copy=True)
    bp = np.ascontiguousarray(_host(plan.block_ptr), dtype=np.int64)
    occ = np.zeros(plan.total_blocks, np.int32)
    _call("preprocess_cluster", plan.num_windows, cfg.words_per_col, cfg.block_w,
          cfg.gather_segment, bp, hind.reshape(-1), bm.reshape(-1), occ)
    return dataclasses.replace(plan, bitmask=torch.from_numpy(bm.view(np.int32)),
                               hind=torch.from_numpy(hind), occ=torch.from_numpy(occ))

"""Window-range slicing of a plan for streamed dispatch (counterpart of
voltrix_spmm_tpu/format/stream.py).

A plan cut into contiguous window ranges runs one chunk after another
(`ops.spmm_streamed`, or `spmm_ad` on a list), and the chunks' outputs
concatenate along rows. Each window's blocks stay as they were, so each
output row is summed exactly as on the whole plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cluster import _host
from .plan import SpmmPlan
from .preprocess import csr_preprocess


def slice_plan_windows(plan: SpmmPlan, num_chunks: int) -> list[SpmmPlan]:
    """Split `plan` into at most `num_chunks` contiguous window ranges of
    equal window count. Each sub-plan holds slices of the plan's tensors on
    the plan's own device (occ and values too), with block_ptr and
    window_of_block rebased; its rows are its window span (the last chunk
    keeps the true row tail), and its gather maps still index the full
    source-row space (num_cols=plan.source_rows)."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    nw = plan.num_windows
    num_chunks = min(num_chunks, nw)
    bp = _host(plan.block_ptr).astype(np.int64)
    W = plan.config.block_h
    per = -(-nw // num_chunks)

    subs = []
    for c in range(num_chunks):
        w0, w1 = c * per, min((c + 1) * per, nw)
        if w0 >= nw:
            break
        b0, b1 = int(bp[w0]), int(bp[w1])
        sub_bp = (bp[w0: w1 + 1] - b0).astype(np.int32)
        subs.append(dataclasses.replace(
            plan,
            bitmask=plan.bitmask[b0:b1],
            hind=plan.hind[b0:b1],
            window_of_block=plan.window_of_block[b0:b1] - w0,
            block_ptr=torch.from_numpy(sub_bp).to(plan.block_ptr.device),
            occ=None if plan.occ is None else plan.occ[b0:b1],
            values=None if plan.values is None else plan.values[b0:b1],
            num_nodes=min(w1 * W, plan.num_nodes) - w0 * W,
            num_edges=0,
            num_windows=w1 - w0,
            total_blocks=b1 - b0,
            has_empty_windows=bool((np.diff(sub_bp) == 0).any()),
            num_cols=plan.source_rows,
        ))
    return subs


def csr_preprocess_streamed(
    indptr,
    indices,
    num_nodes: int,
    config,
    num_chunks: int = 8,
    backend: str = "numpy",
    device="cuda",
    num_cols: int | None = None,
) -> list[SpmmPlan]:
    """Build the plan chunk by chunk: each window-aligned row range is
    preprocessed on its own (windows share no state) and moved to `device`
    before the next is built. The result equals
    `slice_plan_windows(csr_preprocess(...), num_chunks)`."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    span = num_cols if num_cols is not None else num_nodes
    W = config.block_h
    nw = max(-(-num_nodes // W), 1)
    num_chunks = max(1, min(num_chunks, nw))
    per = -(-nw // num_chunks)

    subs: list[SpmmPlan] = []
    for c in range(num_chunks):
        r0 = c * per * W
        if r0 >= num_nodes:
            break
        r1 = min((c + 1) * per * W, num_nodes)
        local_ptr = indptr[r0: r1 + 1] - indptr[r0]
        local_idx = indices[indptr[r0]: indptr[r1]]
        sub = csr_preprocess(local_ptr, local_idx, r1 - r0, config, backend=backend,
                             num_cols=span)
        subs.append(sub.to(device))
    return subs


def estimate_gather_bytes(plan_or_nnz, d: int, itemsize: int = 4) -> int:
    """Bytes of a materialised gather, gather_rows x d x itemsize: the
    estimate that says when a plan should stream."""
    rows = plan_or_nnz.gather_rows if isinstance(plan_or_nnz, SpmmPlan) else int(plan_or_nnz)
    return rows * d * itemsize

"""Plain-torch SpMM oracles (counterpart of voltrix_spmm_tpu/ops/reference.py).

`spmm_reference` is the plain version of kernel K1: it runs the plan's
semantics (gather, bitmask expansion, per-block matmul, sum over each
window's blocks) with ordinary torch operators on whatever device the
tensors lie on. `spmm_scipy` computes A @ X straight from the CSR.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.plan import SpmmPlan
from .bitmask import expand_bitmask


def spmm_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """out = A @ feat via the plan, accumulated in float32.

    Holds the expanded masks (total_blocks, block_h, block_w) and the
    gathered rows (total_blocks, block_w, D) at once: an oracle, not a
    fast path."""
    spmm_reference.calls += 1
    n, d = feat.shape
    if n != plan.source_rows:
        raise ValueError(f"feat has {n} rows, plan gathers from {plan.source_rows}")
    if plan.values is not None or plan.src_perm is not None:
        raise NotImplementedError(
            "weighted (K4, ROADMAP.md item 11) and pack_order='incidence' "
            "(item 18) plans are not ported"
        )
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=out_dtype, device=feat.device)
    cfg = plan.config
    hind = plan.hind.reshape(-1).long()
    # clip like the JAX gather: tail lanes of seg > 1 plans may point
    # past the last row, and their bits are zero
    xg = feat.index_select(0, hind.clamp(0, n - 1)).float()
    xg = xg.reshape(plan.total_blocks, cfg.block_w, d)
    masks = expand_bitmask(plan.bitmask, cfg.block_h, torch.float32)  # (B, H, K)
    contrib = torch.einsum("bhk,bkd->bhd", masks, xg)
    out = torch.zeros(
        plan.num_windows, cfg.block_h, d, dtype=torch.float32, device=feat.device
    )
    out.index_add_(0, plan.window_of_block.long(), contrib)
    return out.reshape(plan.padded_nodes, d)[: plan.num_nodes].to(out_dtype)


spmm_reference.calls = 0  # plain-int call count, read by chip_smoke.py


def spmm_scipy(indptr, indices, num_nodes: int, feat, num_cols: int | None = None) -> np.ndarray:
    """Host oracle: binary CSR @ feat in float64 via scipy."""
    import scipy.sparse as sp

    if isinstance(feat, torch.Tensor):
        feat = feat.detach().cpu().numpy()
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    a = sp.csr_matrix(
        (np.ones(indices.shape[0], dtype=np.float64), indices, indptr),
        shape=(num_nodes, num_cols if num_cols is not None else num_nodes),
    )
    a.sum_duplicates()
    a.data[:] = 1.0
    return np.asarray(a @ np.asarray(feat, dtype=np.float64))

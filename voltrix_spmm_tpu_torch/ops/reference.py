"""Plain-torch SpMM oracles (counterpart of voltrix_spmm_tpu/ops/reference.py).

`spmm_reference` is the plain version of kernel K1: it runs the plan's
semantics (gather, bitmask expansion, per-block matmul, sum over each
window's blocks) with ordinary torch operators on whatever device the
tensors lie on. `block_sum` is the body it shares with the plain
versions of K2 (ops/subtile_spmm.py), K3 (ops/fused_spmm.py) and K4
(ops/weighted.py).
`spmm_scipy` computes A @ X straight from the CSR.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.plan import SpmmPlan
from .bitmask import expand_bitmask


# bytes of masks, gathered rows and products the plain versions hold at
# once: they walk the blocks in chunks of this size
CHUNK_BYTES = 256 * 2**20


def block_sum(plan: SpmmPlan, feat: torch.Tensor, gather, sub_keep=None,
              chunk_bytes: int = CHUNK_BYTES, tiles=None) -> torch.Tensor:
    """The body the plain versions of K1-K4 share: for each chunk of
    blocks, take the blocks' (block_h, block_w) tiles (the expanded masks,
    or `tiles(b0, b1)`: K4's value tiles), multiply them by the chunk's
    gathered rows `gather(b0, b1)` (a (c, block_w, D) float32 tensor) and
    add the products into their windows with `index_add_`, in block order.

    sub_keep: optional float (total_blocks, block_h // 128) 0/1 tensor;
    sub-window s of block b is added only where sub_keep[b, s] is 1 (K2's
    occupancy skip). Returns float32 (num_nodes, D)."""
    d = feat.shape[1]
    cfg = plan.config
    H, K = cfg.block_h, cfg.block_w
    out = torch.zeros(plan.num_windows, H, d, dtype=torch.float32, device=feat.device)
    step = max(1, chunk_bytes // (4 * (H * K + K * d + H * d)))
    wob = plan.window_of_block.long()
    for b0 in range(0, plan.total_blocks, step):
        b1 = min(plan.total_blocks, b0 + step)
        if tiles is not None:
            masks = tiles(b0, b1)
        else:
            masks = expand_bitmask(plan.bitmask[b0:b1], H, torch.float32)  # (c, H, K)
        if sub_keep is not None:
            masks *= sub_keep[b0:b1].repeat_interleave(128, dim=1)[:, :, None]
        out.index_add_(0, wob[b0:b1], torch.bmm(masks, gather(b0, b1)))
    return out.reshape(plan.padded_nodes, d)[: plan.num_nodes]


def clipped_gather(plan: SpmmPlan, feat: torch.Tensor):
    """`gather(b0, b1)` for `block_sum`: the rows behind each lane's hind,
    clipped like the JAX gather (tail lanes of seg > 1 plans may point
    past the last row; their bits are zero)."""
    n, d = feat.shape
    hind = plan.hind.long().clamp(0, n - 1)
    k = plan.config.block_w

    def gather(b0, b1):
        return feat.index_select(0, hind[b0:b1].reshape(-1)).float().reshape(b1 - b0, k, d)

    return gather


def check_binary(plan: SpmmPlan, feat: torch.Tensor) -> None:
    if feat.shape[0] != plan.source_rows:
        raise ValueError(f"feat has {feat.shape[0]} rows, plan gathers from {plan.source_rows}")
    if plan.values is not None:
        # a binary SpMM would silently drop the plane: (A o V) @ X != A @ X
        raise ValueError(
            "plan carries a value plane; use ops.spmm(plan, feat) or "
            "spmm_weighted: this is the binary SpMM"
        )
    if plan.src_perm is not None:
        raise NotImplementedError(
            "pack_order='incidence' plans are not ported (ROADMAP.md item 18)"
        )


def spmm_reference(plan: SpmmPlan, feat: torch.Tensor, out_dtype=None, *,
                   chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """out = A @ feat via the plan, accumulated in float32: the plain
    version of kernel K1 (and the oracle of every binary plan).

    Walks the blocks in chunks of at most `chunk_bytes` of masks, rows and
    products: an oracle, not a fast path."""
    spmm_reference.calls += 1
    check_binary(plan, feat)
    d = feat.shape[1]
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if plan.total_blocks == 0:
        return torch.zeros(plan.num_nodes, d, dtype=out_dtype, device=feat.device)
    return block_sum(plan, feat, clipped_gather(plan, feat), chunk_bytes=chunk_bytes).to(out_dtype)


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

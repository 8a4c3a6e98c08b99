"""The hybrid SpMM: the dense-run part and the scattered part of a
`HybridPlan`, summed (counterpart of voltrix_spmm_tpu/ops/hybrid.py).

A composition over the kernels of the two sides, with no kernel of its
own: the dense side runs K3 (dense_impl="fused", the default) or K1 / K2
(dense_impl="pregather"); the sparse side runs K1, or K2 with
`subtile=True`. A side without blocks launches nothing.
"""

from __future__ import annotations

import torch

from ..format.hybrid import HybridPlan
from .block_spmm import cast_out, spmm_block
from .fused_spmm import spmm_fused
from .reference import spmm_reference
from .subtile_spmm import spmm_subtile


def _sum_sides(plan: HybridPlan, feat: torch.Tensor, dense, sparse, out_dtype) -> torch.Tensor:
    """dense(plan.dense, feat) + sparse(plan.sparse, feat) in float32, each
    side only if it has blocks (zeros when neither has), cast at the end."""
    out = None
    if plan.dense.total_blocks > 0:
        out = dense(plan.dense, feat)
    if plan.sparse.total_blocks > 0:
        part = sparse(plan.sparse, feat)
        out = part if out is None else out + part
    if out is None:
        out = torch.zeros(plan.num_nodes, feat.shape[1], dtype=torch.float32, device=feat.device)
    return cast_out(out, out_dtype)


def spmm_hybrid(plan: HybridPlan, feat: torch.Tensor, dense_impl: str = "auto",
                subtile: bool = False, out_dtype=None) -> torch.Tensor:
    """out = A_dense @ feat + A_sparse @ feat through the sides' kernels.
    The sides are summed in float32 and cast to `out_dtype` once (the JAX
    package casts each side, then adds)."""
    if dense_impl == "auto":
        # the JAX package sends seg_interleaved and incidence-packed dense
        # sides to "pregather"; the port builds neither
        dense_impl = "fused"
    if dense_impl not in ("fused", "pregather"):
        raise ValueError(f"dense_impl must be 'auto', 'fused' or 'pregather', not {dense_impl!r}")
    pregather = spmm_subtile if subtile else spmm_block
    dense = spmm_fused if dense_impl == "fused" else pregather
    return _sum_sides(plan, feat, dense, pregather, out_dtype)


def spmm_hybrid_reference(plan: HybridPlan, feat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The plain path of a HybridPlan: `spmm_reference` of each side."""
    return _sum_sides(plan, feat, spmm_reference, spmm_reference, out_dtype)

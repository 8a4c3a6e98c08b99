"""voltrix_spmm_tpu_torch: the PyTorch/CUDA port of voltrix_spmm_tpu.

The JAX package beside it is the reference; this package keeps its
module names and public layouts and runs on an NVIDIA H100 (sm_90a),
with each TPU kernel rewritten by hand in CUDA C++. It never imports
jax or voltrix_spmm_tpu.

  - ``csr_preprocess(indptr, indices, num_nodes, config) -> SpmmPlan``
  - ``spmm(plan, feat) -> out``  with ``out = A @ feat``
  - ``build_graph`` / ``gcn_forward`` / ``GCN`` / ``make_train_step``: the
    GCN serving and training path
  - ``build_gat_graph`` / ``gat_forward`` / ``GAT``: GAT on the weighted
    SpMM (``csr_preprocess(..., values=...)``, ``spmm_weighted_ad``)
"""

from . import project
from .format import PlanConfig, SpmmPlan, csr_preprocess, csr_transpose, edge_slot_map
from .models import (
    GAT,
    GCN,
    GatGraph,
    GraphData,
    build_gat_graph,
    build_graph,
    gat_forward,
    gat_loss,
    gat_params_from_jax,
    gcn_forward,
    gcn_loss,
    gcn_params_from_jax,
    make_train_step,
)
from .ops import sddmm, spmm, spmm_ad, spmm_reference, spmm_weighted_ad
from .utils import calc_diff, relative_error

__version__ = "0.1.0"

__all__ = [
    "PlanConfig",
    "SpmmPlan",
    "csr_preprocess",
    "csr_transpose",
    "edge_slot_map",
    "spmm",
    "spmm_ad",
    "spmm_reference",
    "spmm_weighted_ad",
    "sddmm",
    "build_graph",
    "GraphData",
    "gcn_forward",
    "gcn_loss",
    "gcn_params_from_jax",
    "make_train_step",
    "GCN",
    "build_gat_graph",
    "GatGraph",
    "gat_forward",
    "gat_loss",
    "gat_params_from_jax",
    "GAT",
    "calc_diff",
    "relative_error",
    "project",
]

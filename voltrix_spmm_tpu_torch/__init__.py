"""voltrix_spmm_tpu_torch: the PyTorch/CUDA port of voltrix_spmm_tpu.

The JAX package beside it is the reference; this package keeps its
module names and public layouts and runs on an NVIDIA H100 (sm_90a),
with each TPU kernel rewritten by hand in CUDA C++. It never imports
jax or voltrix_spmm_tpu.

  - ``csr_preprocess(indptr, indices, num_nodes, config) -> SpmmPlan``
  - ``spmm(plan, feat) -> out``  with ``out = A @ feat``, on an
    ``SpmmPlan``, a ``HybridPlan`` (``csr_preprocess_hybrid``) or a list of
    window chunks (``slice_plan_windows``, ``csr_preprocess_streamed``);
    ``spmm(plan, feat, impl="int8")`` on int8 rows (``quantize_rows``)
  - ``build_graph`` / ``gcn_forward`` / ``GCN`` / ``make_train_step``: the
    GCN serving and training path
  - ``build_gat_graph`` / ``gat_forward`` / ``GAT``: GAT on the weighted
    SpMM (``csr_preprocess(..., values=...)``, ``spmm_weighted_ad``)
  - ``csr_preprocess_ell`` / ``build_ell_pair -> EllPlan``: the
    edge-per-lane plan; ``spmm_ell_ad`` and ``sddmm_ell_ad`` on it
  - ``build_ell_graph`` / ``gat_dot_forward`` / ``GATDot``: dot-product
    GAT on the ELL plan; ``spmm_attention_ad`` (one head) /
    ``spmm_attention_mh_ad`` (all heads) / ``gat_flash_forward`` /
    ``GATFlash``: flash GAT on the fused attention;
    ``build_link_candidates`` / ``link_pred_loss`` /
    ``make_link_pred_step``: GCN link prediction with an SDDMM decoder
"""

from . import project
from .format import (
    EllPlan,
    HybridPlan,
    PlanConfig,
    SpmmPlan,
    build_ell_pair,
    csr_preprocess,
    csr_preprocess_ell,
    csr_preprocess_hybrid,
    csr_preprocess_streamed,
    csr_transpose,
    edge_slot_map,
    hybrid_stats,
    lane_values,
    slice_plan_windows,
)
from .models import (
    GAT,
    GCN,
    EllGraph,
    GATDot,
    GATFlash,
    GatGraph,
    GraphData,
    build_ell_graph,
    build_gat_graph,
    build_graph,
    build_link_candidates,
    gat_dot_forward,
    gat_dot_loss,
    gat_dot_params_from_jax,
    gat_flash_forward,
    gat_flash_loss,
    gat_flash_params_from_jax,
    gat_forward,
    gat_loss,
    gat_params_from_jax,
    gcn_forward,
    gcn_loss,
    gcn_params_from_jax,
    init_link_predictor,
    link_auc,
    link_pred_loss,
    link_scores,
    make_gat_flash_train_step,
    make_link_pred_step,
    make_train_step,
)
from .ops import (
    dequantize_rows,
    quantize_rows,
    sddmm,
    sddmm_ell,
    sddmm_ell_ad,
    spmm,
    spmm_ad,
    spmm_attention,
    spmm_attention_ad,
    spmm_attention_mh,
    spmm_attention_mh_ad,
    spmm_ell,
    spmm_ell_ad,
    spmm_hybrid,
    spmm_int8,
    spmm_reference,
    spmm_streamed,
    spmm_weighted_ad,
)
from .utils import calc_diff, relative_error

__version__ = "0.1.0"

__all__ = [
    "PlanConfig",
    "SpmmPlan",
    "csr_preprocess",
    "csr_transpose",
    "edge_slot_map",
    "HybridPlan",
    "csr_preprocess_hybrid",
    "hybrid_stats",
    "slice_plan_windows",
    "csr_preprocess_streamed",
    "spmm",
    "spmm_ad",
    "spmm_int8",
    "spmm_hybrid",
    "spmm_streamed",
    "quantize_rows",
    "dequantize_rows",
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
    "EllPlan",
    "csr_preprocess_ell",
    "build_ell_pair",
    "lane_values",
    "spmm_ell",
    "spmm_ell_ad",
    "sddmm_ell",
    "sddmm_ell_ad",
    "build_ell_graph",
    "EllGraph",
    "gat_dot_forward",
    "gat_dot_loss",
    "gat_dot_params_from_jax",
    "GATDot",
    "spmm_attention",
    "spmm_attention_ad",
    "spmm_attention_mh",
    "spmm_attention_mh_ad",
    "gat_flash_forward",
    "gat_flash_loss",
    "gat_flash_params_from_jax",
    "make_gat_flash_train_step",
    "GATFlash",
    "build_link_candidates",
    "init_link_predictor",
    "link_scores",
    "link_pred_loss",
    "make_link_pred_step",
    "link_auc",
    "calc_diff",
    "relative_error",
    "project",
]

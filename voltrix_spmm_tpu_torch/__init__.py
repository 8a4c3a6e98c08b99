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
  - ``SAGE`` / ``GIN`` / ``APPNP`` / ``DeepGCN`` / ``RGCN`` and their
    ``*_forward``: the other full-graph models, on ``aggregate``;
    ``build_dropedge_graph`` / ``dropedge_aggregate``: DropEdge on the
    weighted SpMM
  - ``data.sample_blocks`` / ``SageMinibatch`` / ``make_sage_minibatch_step``
    / ``sage_inference``: neighbour-sampled mini-batch GraphSAGE
  - ``data.block_diagonal`` / ``graph_readout`` / ``GINClassifier``: GIN
    graph classification over block-diagonal batches
  - deployment: ``SpmmPlan.save`` / ``SpmmPlan.load`` (plan files of either
    package), ``validate_plan``, ``csr_preprocess(backend="native")`` (the
    C++/OpenMP preprocess), ``serve`` (``export_servable``, ``load_servable``,
    ``save_bundle``, ``load_bundle``, ``aot_compile``, ``compiled_stats``),
    ``save_checkpoint`` / ``load_checkpoint``, ``profiling``, the tuple API
    (``csr_preprocess_tuple`` / ``spmm_tuple``) and the command line,
    ``python -m voltrix_spmm_tpu_torch``
  - the autotuner: ``tune_spmm`` / ``SpmmTuner -> TunedSpmm`` races
    ``Variant``s of ``default_space`` (K1, K2, K3, the hybrids; K4 and K6
    with values) on the card, ``tune_attention -> TunedAttention`` races
    ``AttnVariant``s of K13-K15; ``build_graph(config="auto")`` picks a
    plan without timing
"""

from . import data, profiling, project, serve
from .compat import BLK_H, BLK_W, csr_preprocess_tuple, spmm_tuple
from .format import (
    EllPlan,
    HybridPlan,
    PlanConfig,
    PlanInvariantError,
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
    validate_plan,
)
from .models import (
    APPNP,
    DeepGCN,
    DropEdgeGraph,
    EllGraph,
    GAT,
    GATDot,
    GATFlash,
    GCN,
    GIN,
    GINClassifier,
    GatGraph,
    GraphData,
    RGCN,
    SAGE,
    SageMinibatch,
    appnp_forward,
    appnp_loss,
    appnp_params_from_jax,
    blocks_args,
    build_dropedge_graph,
    build_ell_graph,
    build_gat_graph,
    build_graph,
    build_link_candidates,
    deep_gcn_forward,
    deep_gcn_loss,
    deep_gcn_params_from_jax,
    dropedge_aggregate,
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
    gin_classifier_forward,
    gin_classifier_loss,
    gin_classifier_params_from_jax,
    gin_forward,
    gin_params_from_jax,
    graph_readout,
    init_link_predictor,
    link_auc,
    link_pred_loss,
    link_scores,
    load_checkpoint,
    make_classifier_train_step,
    make_deep_train_step,
    make_gat_flash_train_step,
    make_link_pred_step,
    make_rgcn_train_step,
    make_sage_minibatch_step,
    make_train_step,
    rgcn_forward,
    rgcn_loss,
    rgcn_params_from_jax,
    sage_forward,
    sage_inference,
    sage_minibatch_forward,
    sage_minibatch_loss,
    sage_minibatch_params_from_jax,
    sage_params_from_jax,
    save_checkpoint,
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
from .tuner import (
    AttnVariant,
    SpmmTuner,
    TunedAttention,
    TunedSpmm,
    Variant,
    default_space,
    tune_attention,
    tune_spmm,
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
    "APPNP",
    "DeepGCN",
    "DropEdgeGraph",
    "GIN",
    "GINClassifier",
    "RGCN",
    "SAGE",
    "SageMinibatch",
    "appnp_forward",
    "appnp_loss",
    "appnp_params_from_jax",
    "blocks_args",
    "build_dropedge_graph",
    "deep_gcn_forward",
    "deep_gcn_loss",
    "deep_gcn_params_from_jax",
    "dropedge_aggregate",
    "gin_classifier_forward",
    "gin_classifier_loss",
    "gin_classifier_params_from_jax",
    "gin_forward",
    "gin_params_from_jax",
    "graph_readout",
    "make_classifier_train_step",
    "make_deep_train_step",
    "make_rgcn_train_step",
    "make_sage_minibatch_step",
    "rgcn_forward",
    "rgcn_loss",
    "rgcn_params_from_jax",
    "sage_forward",
    "sage_inference",
    "sage_minibatch_forward",
    "sage_minibatch_loss",
    "sage_minibatch_params_from_jax",
    "sage_params_from_jax",
    "data",
    "calc_diff",
    "relative_error",
    "project",
    "PlanInvariantError",
    "validate_plan",
    "serve",
    "profiling",
    "BLK_H",
    "BLK_W",
    "csr_preprocess_tuple",
    "spmm_tuple",
    "save_checkpoint",
    "load_checkpoint",
    "tune_spmm",
    "TunedSpmm",
    "Variant",
    "SpmmTuner",
    "default_space",
    "tune_attention",
    "TunedAttention",
    "AttnVariant",
]

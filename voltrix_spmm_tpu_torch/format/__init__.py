from .cluster import (block_occupancy, cluster_window_columns, pack_bitmask, packed_stats,
                      subtile_stats, unpack_bitmask, unpack_bitmask_np)
from .diagnostics import PlanInvariantError, validate_plan
from .ell import (
    EllPlan,
    build_ell_pair,
    csr_preprocess_ell,
    edge_values,
    ell_stats,
    ell_transpose,
    lane_values,
    slice_ell_windows,
)
from .hybrid import HybridPlan, csr_preprocess_hybrid, hybrid_stats
from .plan import PlanConfig, SpmmPlan
from .preprocess import (
    coverage_expansion,
    csr_preprocess,
    csr_transpose,
    edge_slot_map,
    expand_bitmask_np,
    pad_empty_windows,
    plan_stats,
    plan_to_dense,
)
from .stream import csr_preprocess_streamed, estimate_gather_bytes, slice_plan_windows

__all__ = [
    "EllPlan",
    "HybridPlan",
    "PlanConfig",
    "SpmmPlan",
    "build_ell_pair",
    "csr_preprocess_ell",
    "edge_values",
    "ell_stats",
    "ell_transpose",
    "lane_values",
    "slice_ell_windows",
    "block_occupancy",
    "cluster_window_columns",
    "coverage_expansion",
    "csr_preprocess",
    "csr_preprocess_hybrid",
    "csr_preprocess_streamed",
    "csr_transpose",
    "edge_slot_map",
    "estimate_gather_bytes",
    "hybrid_stats",
    "slice_plan_windows",
    "subtile_stats",
    "pack_bitmask",
    "packed_stats",
    "unpack_bitmask",
    "unpack_bitmask_np",
    "PlanInvariantError",
    "validate_plan",
    "expand_bitmask_np",
    "pad_empty_windows",
    "plan_stats",
    "plan_to_dense",
]

from .cluster import block_occupancy, cluster_window_columns, subtile_stats
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

__all__ = [
    "PlanConfig",
    "SpmmPlan",
    "block_occupancy",
    "cluster_window_columns",
    "coverage_expansion",
    "csr_preprocess",
    "csr_transpose",
    "edge_slot_map",
    "subtile_stats",
    "expand_bitmask_np",
    "pad_empty_windows",
    "plan_stats",
    "plan_to_dense",
]

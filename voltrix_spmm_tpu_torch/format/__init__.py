from .plan import PlanConfig, SpmmPlan
from .preprocess import (
    csr_preprocess,
    expand_bitmask_np,
    pad_empty_windows,
    plan_stats,
    plan_to_dense,
)

__all__ = [
    "PlanConfig",
    "SpmmPlan",
    "csr_preprocess",
    "expand_bitmask_np",
    "pad_empty_windows",
    "plan_stats",
    "plan_to_dense",
]

"""The autotuner: races the port's kernels on measured time, with memory
and disk caches (counterpart of voltrix_spmm_tpu/tuner)."""

from .attention import (
    AttentionTuner,
    AttnVariant,
    TunedAttention,
    attention_default_space,
    tune_attention,
)
from .tuner import (
    SpmmTuner,
    TunedSpmm,
    Variant,
    default_space,
    tune_spmm,
    weighted_default_space,
)

__all__ = [
    "SpmmTuner",
    "TunedSpmm",
    "tune_spmm",
    "default_space",
    "weighted_default_space",
    "Variant",
    "AttentionTuner",
    "AttnVariant",
    "TunedAttention",
    "attention_default_space",
    "tune_attention",
]

"""Accuracy utilities (counterpart of voltrix_spmm_tpu/utils.py:28-47).

Both metrics are taken in float64 on the host, so a tensor on the card
is copied back first.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger("voltrix_torch")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def calc_diff(x, y) -> float:
    """Cosine-style "difference rate": ``1 - 2 x·y / (|x|^2 + |y|^2)``.
    0.0 means identical."""
    x, y = _to_numpy(x), _to_numpy(y)
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        logger.warning("calc_diff: non-finite values present")
    denom = (x * x).sum() + (y * y).sum()
    if denom == 0.0:
        return 0.0
    sim = 2.0 * (x * y).sum() / denom
    return float(1.0 - sim)


def relative_error(ref, out, eps: float = 1e-12) -> float:
    """Frobenius relative error |out - ref| / |ref|."""
    ref, out = _to_numpy(ref), _to_numpy(out)
    return float(np.linalg.norm(out - ref) / (np.linalg.norm(ref) + eps))

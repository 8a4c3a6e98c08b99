"""Bitmask expansion in plain torch (counterpart of
voltrix_spmm_tpu/ops/bitmask.py).

Words are packed along rows: bit ``s`` of word ``w`` at lane ``j`` is
window row ``32*w+s``. The plan holds them as int32; an arithmetic shift
followed by ``& 1`` reads every bit of the word, bit 31 included.
"""

from __future__ import annotations

import torch


def expand_bitmask(words: torch.Tensor, block_h: int, dtype=torch.float32) -> torch.Tensor:
    """(..., words_per_col, K) int32 -> (..., block_h, K) 0/1 tensor of `dtype`."""
    if words.dtype != torch.int32:
        raise TypeError(f"bitmask must be int32 (uint32 bits), got {words.dtype}")
    *lead, nwords, k = words.shape
    if nwords * 32 < block_h:
        raise ValueError(f"{nwords} words cannot hold {block_h} rows")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-2) >> shifts.view(32, 1)) & 1  # (..., nwords, 32, K)
    return bits.reshape(*lead, nwords * 32, k)[..., :block_h, :].to(dtype)

"""Save and restore training state (counterpart of
voltrix_spmm_tpu/models/checkpoint.py, which uses orbax).

The state is a tree of tensors (a parameter dict, a module's or an
optimizer's `state_dict()`, or nested dicts, lists and tuples of them),
written with `torch.save` through a per-process temporary file and
`os.replace`, and read back with `torch.load(weights_only=True)`, which
unpickles tensors and plain containers only.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state) -> str:
    """Write `state` (a tree of tensors, or an object with `state_dict()`)
    to `path` atomically; return the absolute path."""
    path = os.path.abspath(path)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def _like(tree, like):
    if isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(t, v) for t, v in zip(tree, like))
    return tree


def load_checkpoint(path: str, like=None, map_location="cpu"):
    """The state `save_checkpoint` wrote. With `like` (a tree of the same
    structure, or a module or optimizer) each tensor comes back with the
    dtype and on the device of its counterpart in `like` (a module or
    optimizer loads the state and is returned); without it, on
    `map_location`."""
    state = torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
    if like is None:
        return state
    if hasattr(like, "load_state_dict"):
        like.load_state_dict(state)
        return like
    return _like(state, like)

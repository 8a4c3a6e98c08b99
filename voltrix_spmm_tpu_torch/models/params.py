"""Parameter trees in the JAX package's layouts, as tensors and as modules.

The JAX models keep their weights in trees of dicts and lists of arrays
(`init_rgcn`'s {"layers": [{...}, {...}]}, `init_sage_minibatch`'s list
of dicts). `params_from_jax` turns such a tree into float32 tensors on a
device; `ParamTree` holds one as the parameters of an nn.Module, so a
torch.optim optimizer can step it, and gives the tree back (`params()`)
for the functional forwards.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_jax(tree, device="cuda"):
    """A tree of dicts and lists of arrays (numpy, or anything np.asarray
    takes) -> the same tree of float32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=torch.float32, device=device)


def normal(generator, shape, scale, device):
    """Standard normal draws of `shape` from `generator` on the CPU, times
    `scale`, moved to `device` (a GCN-style init: the same generator gives
    the same weights on every device)."""
    return (torch.randn(*shape, generator=generator) * scale).to(device)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}_")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}_")
    else:
        yield prefix[:-1], tree


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _rebuild(layout, params, prefix=""):
    if isinstance(layout, dict):
        return {k: _rebuild(v, params, f"{prefix}{k}_") for k, v in layout.items()}
    if isinstance(layout, (list, tuple)):
        return [_rebuild(v, params, f"{prefix}{i}_") for i, v in enumerate(layout)]
    return params[prefix[:-1]]


class ParamTree(nn.Module):
    """An nn.Module whose parameters are the leaves of a tree of dicts and
    lists, each registered under its path joined by "_" ("layers_0_w_self");
    `params()` returns the tree with the parameters at its leaves."""

    def _set_tree(self, tree) -> None:
        self._layout = _skeleton(tree)
        for name, t in _leaves(tree):
            self.register_parameter(name, nn.Parameter(t.detach().clone()))

    @classmethod
    def from_params(cls, params):
        """A module holding copies of the tensors of `params` (a tree as
        `params_from_jax` returns), without drawing weights."""
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model._set_tree(params)
        return model

    def tree(self, flat):
        """The parameter tree with the tensors of `flat` (a mapping from the
        registered names, as dict(self.named_parameters())) at its leaves."""
        return _rebuild(self._layout, flat)

    def params(self):
        return self.tree(dict(self.named_parameters()))

"""Data- and tensor-parallel GCN over a ("data", "model") mesh
(counterpart of voltrix_spmm_tpu/parallel/sharded.py).

SpMM with a replicated plan is parallel over the feature dim with no
collective; GCN training composes that with Megatron-style tensor
parallelism (column-parallel W1, row-parallel W2 and a sum over "model")
and a gradient mean over "data". Each rank holds its slices of the
parameters (`gcn_param_specs`, `local_gcn_params`) and its graphs of the
batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.graph import GraphData, aggregate
from ..ops import spmm
from . import comm


def dp_tp(n_devices: int, dp: int | None = None, tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) of `make_mesh`: tp is 4 on a multiple of 4 from 8 ranks,
    else 2 on an even count, else 1, unless dp and tp are both given."""
    if dp is None or tp is None:
        if n_devices % 4 == 0 and n_devices >= 8:
            tp = 4
        elif n_devices % 2 == 0:
            tp = 2
        else:
            tp = 1
        dp = n_devices // tp
    if dp * tp != n_devices:
        raise ValueError(f"dp {dp} x tp {tp} != {n_devices} ranks")
    return dp, tp


def make_mesh(n_devices: int | None = None, dp: int | None = None, tp: int | None = None):
    """A ("data", "model") DeviceMesh over the world's ranks
    (`comm.device_mesh`, rank i * tp + j at (i, j)); n_devices (default:
    the world size) must be the world size; (dp, tp) by `dp_tp`."""
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh spans the world: n_devices {n_devices} != world size {world}")
    return comm.device_mesh(dp_tp(n_devices, dp, tp), ("data", "model"))


def sharded_spmm(plan, feat: torch.Tensor, mesh) -> torch.Tensor:
    """SpMM with the feature dim sharded over "model": `feat` is this
    rank's column slice of X; the plan is replicated and the result is the
    same column slice of A @ X. No collective."""
    return spmm(plan, feat)


def gcn_param_specs() -> dict:
    """Megatron-style specs (a mesh axis or None per dim, as the JAX
    PartitionSpecs): W1 column-parallel, W2 row-parallel."""
    return {"w1": (None, "model"), "b1": ("model",), "w2": ("model", None), "b2": ()}


def local_gcn_params(params, mesh, device=None) -> dict:
    """This rank's slices (`gcn_param_specs`) of the full GCN parameters
    in the JAX `init_gcn` layout, carried across by `gcn_params_from_jax`
    to `device` (the card unless "cpu")."""
    from ..models import gcn_params_from_jax

    tp, j = mesh.size(mesh.mesh_dim_names.index("model")), mesh.get_local_rank("model")
    full = gcn_params_from_jax(params, comm.rank_device(device))
    out = {}
    for name, spec in gcn_param_specs().items():
        t = full[name]
        if "model" in spec:
            dim = spec.index("model")
            if t.shape[dim] % tp:
                raise ValueError(f"{name} dim {dim} ({t.shape[dim]}) does not split over tp {tp}")
            t = t.chunk(tp, dim)[j].contiguous()
        out[name] = t
    return out


def full_gcn_params(slices) -> dict:
    """The full parameters (numpy) from the slices of model ranks 0..tp-1
    (a list of dicts in that order): the inverse of `local_gcn_params`."""
    out = {}
    for name, spec in gcn_param_specs().items():
        parts = [np.asarray(s[name]) for s in slices]
        out[name] = np.concatenate(parts, axis=spec.index("model")) if "model" in spec \
            else parts[0]
    return out


def _local_gcn_forward(params, g: GraphData, x: torch.Tensor, model_group) -> torch.Tensor:
    """This rank's GCN forward: `x` is its (B_local, N, D) graphs with full
    features, `params` its tensor-parallel slices."""
    h = aggregate(g, x, mode="mean")
    h = torch.relu(h @ params["w1"] + params["b1"])  # (B, N, H / tp)
    h = aggregate(g, h, mode="mean")  # feature-sharded: no collective
    partial = h @ params["w2"]  # row-parallel partial sums
    return comm.allreduce_identity_bwd(partial, model_group) + params["b2"]


def sharded_gcn_forward(params, g: GraphData, x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's logits (B_local, N, classes) of its graphs `x`."""
    return _local_gcn_forward(params, g, x, mesh.get_group("model"))


def make_sharded_train_step(mesh, lr: float = 1e-2):
    """The SPMD GCN training step over the ("data", "model") mesh:
    `step(params, g, x, y) -> (params, loss)` on this rank's parameter
    slices, its (B_local, N, D) graphs and (B_local, N) labels; the batch
    is sharded over "data", whose gradients and loss are averaged; W1 is
    column- and W2 row-parallel over "model" with a sum whose backward is
    the identity. The new slices are p - lr * g."""
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    dp = dist.get_world_size(data_group)

    def step(params, g: GraphData, x: torch.Tensor, y: torch.Tensor):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = _local_gcn_forward(p, g, x, model_group)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
        grads = torch.autograd.grad(loss, list(p.values()))
        # average over "data" (the slices are replicated across it), the
        # loss with the gradients in one all-reduce
        flat = comm.psum(torch.cat([gr.reshape(-1) for gr in grads] + [loss.reshape(1)]),
                         data_group) / dp
        new, at = {}, 0
        for (k, v), gr in zip(p.items(), grads):
            new[k] = (v - lr * flat[at: at + gr.numel()].view_as(v)).detach()
            at += gr.numel()
        return new, flat[-1]

    return step

"""Hybrid multi-host SpMM: an all-gather over hosts and a ring over the
chips of a host (counterpart of voltrix_spmm_tpu/parallel/hybrid.py).

On a 2D ("host", "chip") mesh:

- forward: ONE all-gather of the local X chunk over the host axis (the
  cross-host traffic, paid once), then an (nchip - 1)-hop ring over the
  chip axis, each travelling bundle's block SpMMs (K1 on the card) run
  while the next bundle is in flight;
- backward (the op is linear in X): the transpose blocks run a
  reduce-scatter ring over the chip axis with a travelling accumulator
  bundle, then ONE reduce-scatter over hosts lands each rank's dX rows.

It reuses `RingShardedPlan`: the ndev x ndev block grid is topology-free;
only the order of traversal changes. Rank (h, c) of an (nhost, nchip) mesh
owns global row shard h * nchip + c.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import comm
from .ring import RingShardedPlan, _block_spmm
from .row_sharded import check_rows
from .row_sharded_gcn import FullGraphStep, local_inv_deg


def _hybrid_fwd(plans, host_group, chip_group, x: torch.Tensor) -> torch.Tensor:
    nhost, nchip = dist.get_world_size(host_group), dist.get_world_size(chip_group)
    c = dist.get_rank(chip_group)
    rows = x.shape[0]
    # one transfer over hosts: every host's chunk at THIS chip position
    bundle = comm.all_gather(x.contiguous(), host_group).view(nhost, rows, -1)
    out = None
    for t in range(nchip):
        # the next bundle in flight while this one multiplies
        pending = comm.ppermute(bundle, chip_group, 1) if t + 1 < nchip else None
        c_src = (c - t) % nchip
        for hp in range(nhost):
            part = _block_spmm(plans, hp * nchip + c_src, bundle[hp])
            out = part if out is None else out + part
        if pending is not None:
            bundle = pending.wait()
    return out.to(x.dtype)


def _hybrid_bwd(plans_t, host_group, chip_group, g: torch.Tensor) -> torch.Tensor:
    nhost, nchip = dist.get_world_size(host_group), dist.get_world_size(chip_group)
    c = dist.get_rank(chip_group)
    g32 = g.to(torch.float32).contiguous()

    def host_stack(c_src):
        # this rank's gradient's share of every host's chunk at chip
        # column c_src: (nhost, rows, d)
        return torch.stack([_block_spmm(plans_t, hp * nchip + c_src, g32)
                            for hp in range(nhost)])

    # the reduce-scatter ring over chips (ring.py's backward at the chip
    # level, a bundle per host): the accumulator destined for chip column
    # c_src visits every chip of this host and lands home
    acc = host_stack((c + 1) % nchip)
    for t in range(1, nchip):
        pending = comm.ppermute(acc, chip_group, -1)
        part = host_stack((c + 1 + t) % nchip)
        acc = pending.wait() + part
    # one collective over hosts: sum over host rows, slot hp to host hp
    dx = comm.psum_scatter(acc.reshape(-1, acc.shape[-1]), host_group)
    return dx.to(g.dtype)


class _Hybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plans, plans_t, host_group, chip_group):
        ctx.plans_t, ctx.groups = plans_t, (host_group, chip_group)
        return _hybrid_fwd(plans, host_group, chip_group, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.plans_t is None:
            raise ValueError("build_ring_sharded_plan(..., with_transpose=True) required for "
                             "the hybrid backward")
        return _hybrid_bwd(ctx.plans_t, *ctx.groups, g), None, None, None, None


def _setup(plan: RingShardedPlan, mesh, host_axis, chip_axis, what):
    """(host group, chip group, this rank's shard h * nchip + c)."""
    host_group = comm.axis_group(mesh, host_axis)
    chip_group = comm.axis_group(mesh, chip_axis)
    nhost, nchip = dist.get_world_size(host_group), dist.get_world_size(chip_group)
    if nhost * nchip != plan.ndev:
        raise ValueError(f"{what}: a {nhost} x {nchip} mesh does not hold the plan's "
                         f"{plan.ndev} shards")
    return host_group, chip_group, dist.get_rank(host_group) * nchip + dist.get_rank(chip_group)


def hybrid_sharded_spmm(plan: RingShardedPlan, feat: torch.Tensor, mesh, host_axis="host",
                        chip_axis="chip") -> torch.Tensor:
    """This rank's rows of A @ X on a (host_axis, chip_axis) mesh: `feat`
    is its (shard_rows, D) rows of X (`plan.rows_of(x, h * nchip + c)`);
    differentiable when the plan has its transpose blocks."""
    check_rows(feat, plan.shard_rows, "hybrid_sharded_spmm")
    host_group, chip_group, index = _setup(plan, mesh, host_axis, chip_axis,
                                           "hybrid_sharded_spmm")
    plans, plans_t = plan.local(index, feat.device)
    return _Hybrid.apply(feat, plans, plans_t, host_group, chip_group)


def make_hybrid_train_step(plan: RingShardedPlan, mesh, inv_deg, lr: float = 1e-2,
                           host_axis="host", chip_axis="chip", device=None) -> FullGraphStep:
    """Full-graph GCN training step over the hybrid SpMM: both aggregation
    layers pay one all-gather over hosts and a chip ring forward, and a
    chip ring and one reduce-scatter over hosts backward. The contract of
    `make_ring_train_step`, with this rank's rows `plan.rows_of(x, h *
    nchip + c)`."""
    if plan.tbt_max == 0:
        raise ValueError("build_ring_sharded_plan(..., with_transpose=True) required for "
                         "training")
    host_group, chip_group, index = _setup(plan, mesh, host_axis, chip_axis,
                                           "make_hybrid_train_step")
    device = comm.rank_device(device)
    plans, plans_t = plan.local(index, device)
    return FullGraphStep(
        lambda h: _Hybrid.apply(h, plans, plans_t, host_group, chip_group),
        local_inv_deg(plan, inv_deg, index, device), plan.shard_rows, lr,
        comm.axis_group(mesh, (host_axis, chip_axis)), "make_hybrid_train_step")

"""The edge-per-lane (ELL) plan as a container of torch tensors
(counterpart of voltrix_spmm_tpu/format/ell.py).

Rows of A are grouped into windows of ``block_h`` rows, as in `SpmmPlan`,
but a lane is one CSR edge, not a deduplicated column. Within a window the
edges are sorted by (column, row) and laid out across the window's blocks
of ``block_w`` lanes:

  hind[b, l]  int32  source row of X behind lane l (column of A)
  erow[b, l]  int32  window-local destination row of lane l (-1 padding)
  vals[b, l]  f32    edge value (0.0 on padding lanes)

so values cost 4 bytes per edge plus the padding of each window to whole
blocks, against the dense (block_h, block_w) tile per block of a weighted
`SpmmPlan`. Duplicate (row, col) edges keep separate lanes and sum in the
product. ``edge_lane`` maps each CSR edge to its flat lane slot and
``lane_edge`` is its inverse (-1 on padding lanes): `lane_values` builds
the lane plane from per-edge tensors, `edge_values` reads it back.

The numpy pass is the JAX package's, so a CSR gives bit-identical arrays
in both packages, and `save`/`load` share the JAX package's .npz layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .cluster import _host
from .plan import PlanConfig
from .preprocess import _cdiv, csr_transpose, pad_empty_windows

_TENSOR_FIELDS = ("hind", "erow", "vals", "window_of_block", "block_ptr", "edge_lane", "lane_edge")


@dataclass
class EllPlan:
    hind: torch.Tensor  # int32 (total_blocks, block_w) source row per lane
    erow: torch.Tensor  # int32 (total_blocks, block_w) window-local row, -1 padding
    vals: torch.Tensor  # float32 (total_blocks, block_w) edge value, 0 padding
    window_of_block: torch.Tensor  # int32 (total_blocks,)
    block_ptr: torch.Tensor  # int32 (num_windows + 1,) exclusive block prefix
    # int32 (nnz,) flat lane slot (block * block_w + lane) of every CSR edge,
    # in CSR order; None on the window slices of `slice_ell_windows`
    edge_lane: torch.Tensor | None
    # int32 (total_blocks * block_w,) CSR edge of every lane, -1 on padding
    lane_edge: torch.Tensor | None
    config: PlanConfig
    num_nodes: int
    num_edges: int
    num_windows: int
    total_blocks: int
    has_empty_windows: bool = False
    num_cols: int | None = None  # source (column) space size; None = square

    @property
    def padded_nodes(self) -> int:
        return self.num_windows * self.config.block_h

    @property
    def source_rows(self) -> int:
        return self.num_cols if self.num_cols is not None else self.num_nodes

    @property
    def gather_rows(self) -> int:
        return self.total_blocks * self.config.block_w

    def to(self, device) -> "EllPlan":
        """A copy with every tensor on `device`: move a plan once, when the
        graph is built."""
        return dataclasses.replace(
            self,
            **{name: getattr(self, name).to(device) for name in _TENSOR_FIELDS
               if getattr(self, name) is not None},
        )

    def save(self, path: str) -> str:
        """Write the plan to one .npz in the JAX package's layout (a JSON
        header of the metadata beside the arrays), atomically; return the
        path."""
        header = json.dumps({
            "config": dataclasses.asdict(self.config),
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "num_windows": self.num_windows,
            "total_blocks": self.total_blocks,
            "has_empty_windows": self.has_empty_windows,
            "num_cols": self.num_cols,
        })
        arrays = {name: _host(getattr(self, name)) for name in _TENSOR_FIELDS
                  if getattr(self, name) is not None}
        arrays["header"] = np.frombuffer(header.encode(), np.uint8)
        if not path.endswith(".npz"):
            path += ".npz"
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp.removesuffix(".npz"), **arrays)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "EllPlan":
        """Read a plan written by `save` of either package (tensors on the
        CPU)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["header"]).decode())
            config = PlanConfig(**meta.pop("config"))
            arrays = {name: torch.from_numpy(np.ascontiguousarray(z[name])) if name in z else None
                      for name in _TENSOR_FIELDS}
        return cls(**arrays, config=config, **meta)


def csr_preprocess_ell(
    indptr,
    indices,
    num_nodes: int,
    config: PlanConfig = PlanConfig(128, 128),
    values=None,
    num_cols: int | None = None,
) -> EllPlan:
    """Build an `EllPlan` (tensors on the CPU) from a CSR.

    values: per-edge weights aligned with `indices`; omitted, every lane
    carries 1.0 (the binary plan). Duplicate (row, col) edges keep
    separate lanes, so their products sum."""
    if config.gather_segment != 1 or config.cluster_cols:
        raise ValueError("ELL lanes are exact edges: gather_segment=1, no cluster_cols")
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if indptr.ndim != 1 or indptr.shape[0] != num_nodes + 1 or indices.ndim != 1:
        raise ValueError(
            f"bad CSR: indptr {indptr.shape}, indices {indices.shape}, num_nodes {num_nodes}"
        )
    H, K = config.block_h, config.block_w
    num_windows = max(_cdiv(num_nodes, H), 1)
    nnz = int(indices.shape[0])
    if values is not None:
        values = np.asarray(values, dtype=np.float32)
        if values.shape != indices.shape:
            raise ValueError(f"values {values.shape} must align with indices {indices.shape}")

    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    cols = indices
    win = rows // H

    # edges per window -> blocks per window, padded as the binary plan's
    epw = np.bincount(win, minlength=num_windows) if nnz else np.zeros(num_windows, np.int64)
    blocks_per_window = -(-epw // K)
    if config.block_unroll > 1:
        u = config.block_unroll
        blocks_per_window = -(-blocks_per_window // u) * u
    blocks_per_window = pad_empty_windows(blocks_per_window, config.block_unroll)
    block_ptr = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(blocks_per_window, out=block_ptr[1:])
    total_blocks = int(block_ptr[-1])

    hind = np.zeros(total_blocks * K, np.int32)
    # padding lanes: erow -1 matches no row, so they add nothing forward
    # and receive exactly 0.0 lane gradients
    erow = np.full(total_blocks * K, -1, np.int32)
    vals = np.zeros(total_blocks * K, np.float32)
    lane_edge = np.full(total_blocks * K, -1, np.int32)
    edge_lane = np.zeros(nnz, np.int32)

    if nnz:
        # (window, col, row) order: a window's lanes are contiguous and
        # sorted by column, so its gather walks X near-sequentially
        order = np.lexsort((rows, cols, win))
        win_s = win[order]
        win_start = np.zeros(num_windows + 1, dtype=np.int64)
        np.cumsum(epw, out=win_start[1:])
        p_local = np.arange(nnz, dtype=np.int64) - win_start[win_s]
        slot = block_ptr[win_s] * K + p_local
        hind[slot] = cols[order].astype(np.int32)
        erow[slot] = (rows[order] % H).astype(np.int32)
        vals[slot] = 1.0 if values is None else values[order]
        lane_edge[slot] = order.astype(np.int32)
        edge_lane[order] = slot.astype(np.int32)

    window_of_block = np.repeat(np.arange(num_windows, dtype=np.int32), blocks_per_window)
    return EllPlan(
        hind=torch.from_numpy(hind.reshape(total_blocks, K)),
        erow=torch.from_numpy(erow.reshape(total_blocks, K)),
        vals=torch.from_numpy(vals.reshape(total_blocks, K)),
        window_of_block=torch.from_numpy(window_of_block),
        block_ptr=torch.from_numpy(block_ptr.astype(np.int32)),
        edge_lane=torch.from_numpy(edge_lane),
        lane_edge=torch.from_numpy(lane_edge),
        config=config,
        num_nodes=num_nodes,
        num_edges=nnz,
        num_windows=num_windows,
        total_blocks=total_blocks,
        has_empty_windows=bool((blocks_per_window == 0).any()),
        num_cols=num_cols,
    )


class _LaneValues(torch.autograd.Function):
    """Per-edge vector -> lane plane, a gather through `lane_edge`. Its
    backward is the gather of the gradient plane through `edge_lane`
    (each edge owns exactly one lane), never a scatter: the backward of
    an index gather would add every padding lane's zero into edge 0, one
    atomic after another."""

    @staticmethod
    def forward(ctx, w, lane_edge, edge_lane):
        ctx.save_for_backward(edge_lane)
        plane = w.index_select(0, lane_edge.clamp(min=0))
        return plane.masked_fill_(lane_edge < 0, 0)

    @staticmethod
    def backward(ctx, g):
        (edge_lane,) = ctx.saved_tensors
        return g.reshape(-1).index_select(0, edge_lane), None, None


def lane_values(plan: EllPlan, w: torch.Tensor) -> torch.Tensor:
    """Per-edge parameters (nnz,) in CSR order -> the (total_blocks,
    block_w) lane plane (0 on padding lanes), differentiable in `w`: the
    hook for learned edge weights (attention, DropEdge masks)."""
    if plan.lane_edge is None or plan.edge_lane is None:
        raise ValueError("lane_values needs the plan's edge maps (a window slice has none)")
    if w.shape != (plan.num_edges,):
        raise ValueError(f"w must be ({plan.num_edges},), got {tuple(w.shape)}")
    plane = _LaneValues.apply(w, plan.lane_edge, plan.edge_lane)
    return plane.view(plan.total_blocks, plan.config.block_w)


def edge_values(plan: EllPlan, plane: torch.Tensor | None = None) -> torch.Tensor:
    """Lane plane -> per-edge vector (nnz,) in CSR order, the inverse of
    `lane_values`; plane=None reads plan.vals."""
    if plan.edge_lane is None:
        raise ValueError("edge_values needs the plan's edge maps (a window slice has none)")
    plane = plan.vals if plane is None else plane
    return plane.reshape(-1).index_select(0, plan.edge_lane)


def slice_ell_windows(plan: EllPlan, num_chunks: int) -> list[EllPlan]:
    """Split a plan into window-contiguous sub-plans balanced by block
    count, so a streamed SpMM holds one chunk's work at a time. The
    sub-plans have no edge maps (their lane slots shift)."""
    bp = _host(plan.block_ptr).astype(np.int64)
    num_chunks = max(1, min(num_chunks, plan.num_windows))
    targets = [round(plan.total_blocks * (i + 1) / num_chunks) for i in range(num_chunks)]
    cuts = np.unique(np.searchsorted(bp, targets, side="left"))
    cuts = cuts[(cuts > 0) & (cuts <= plan.num_windows)]
    bounds = np.concatenate([[0], cuts])
    if bounds[-1] != plan.num_windows:
        bounds = np.concatenate([bounds, [plan.num_windows]])
    wob = plan.window_of_block
    subs = []
    for w0, w1 in zip(bounds[:-1], bounds[1:]):
        b0, b1 = int(bp[w0]), int(bp[w1])
        nwin = int(w1 - w0)
        nrows = min(plan.num_nodes - int(w0) * plan.config.block_h, nwin * plan.config.block_h)
        sub_bp = (bp[w0: w1 + 1] - b0).astype(np.int32)
        subs.append(EllPlan(
            hind=plan.hind[b0:b1],
            erow=plan.erow[b0:b1],
            vals=plan.vals[b0:b1],
            window_of_block=wob[b0:b1] - int(w0),
            block_ptr=torch.from_numpy(sub_bp).to(wob.device),
            edge_lane=None,
            lane_edge=None,
            config=plan.config,
            num_nodes=nrows,
            num_edges=-1,
            num_windows=nwin,
            total_blocks=b1 - b0,
            has_empty_windows=bool((np.diff(sub_bp) == 0).any()),
            num_cols=plan.source_rows,
        ))
    return subs


def ell_transpose(indptr, indices, num_nodes: int, values=None,
                  config: PlanConfig | None = None, num_cols: int | None = None) -> EllPlan:
    """The `EllPlan` of A^T, built straight from A's CSR through
    `csr_transpose`."""
    ptr_t, idx_t, vals_t = csr_transpose(indptr, indices, num_nodes, values=values,
                                         num_cols=num_cols)
    span = num_cols if num_cols is not None else num_nodes
    cfg = config if config is not None else PlanConfig(128, 128)
    return csr_preprocess_ell(ptr_t, idx_t, span, cfg, values=vals_t, num_cols=num_nodes)


def build_ell_pair(
    indptr,
    indices,
    num_nodes: int,
    values=None,
    config: PlanConfig = PlanConfig(128, 128),
    config_t: PlanConfig | None = None,
    num_cols: int | None = None,
) -> tuple[EllPlan, EllPlan]:
    """(plan, plan_t) for A and A^T, with BOTH plans' edge maps in A's CSR
    edge order, so one per-edge tensor feeds either side through
    `lane_values`: what `spmm_ell_ad` and `sddmm_ell_ad` take."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    plan = csr_preprocess_ell(indptr, indices, num_nodes, config, values=values,
                              num_cols=num_cols)
    plan_t = ell_transpose(indptr, indices, num_nodes, values=values,
                           config=config_t if config_t is not None else config,
                           num_cols=num_cols)
    # transpose-CSR position p is original edge t_order[p] (csr_transpose's
    # stable counting sort)
    t_order = np.argsort(indices, kind="stable").astype(np.int64)
    el_t = plan_t.edge_lane.numpy()
    le_t = plan_t.lane_edge.numpy()
    edge_lane = np.zeros_like(el_t)
    edge_lane[t_order] = el_t
    lane_edge = np.where(le_t >= 0, t_order[np.maximum(le_t, 0)], -1).astype(np.int32)
    plan_t = dataclasses.replace(plan_t, edge_lane=torch.from_numpy(edge_lane),
                                 lane_edge=torch.from_numpy(lane_edge))
    return plan, plan_t


def ell_stats(plan: EllPlan) -> dict:
    """Packing statistics: lane slots, fill, value bytes per edge."""
    slots = plan.total_blocks * plan.config.block_w
    return {
        "num_nodes": plan.num_nodes,
        "nnz": plan.num_edges,
        "num_windows": plan.num_windows,
        "total_blocks": plan.total_blocks,
        "lane_slots": slots,
        "lane_fill": plan.num_edges / slots if slots else 0.0,
        "value_bytes_per_edge": 4.0 * slots / max(plan.num_edges, 1),
    }

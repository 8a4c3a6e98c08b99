"""The binned block-CSR plan as a container of torch tensors.

Counterpart of voltrix_spmm_tpu/format/plan.py, with the same fields
and meaning:

- Rows of A are grouped into windows of ``block_h`` consecutive rows.
- Within a window the distinct neighbour columns are sorted and packed,
  ``block_w`` of them to a block.
- Per block, ``hind[b, j]`` is the source row of X behind lane j, and
  ``bitmask[b, w, j]`` holds the presence bits: bit ``s`` of word ``w``
  at lane ``j`` is set iff A[window row 32*w+s, hind[b, j]] == 1.
- ``block_ptr`` is the exclusive block prefix per window and
  ``window_of_block`` the window of each block.

The bitmask is held as int32 carrying the uint32 bits unchanged: torch's
CPU kernels do not shift uint32 tensors, and an arithmetic shift of the
int32 word followed by ``& 1`` still reads every bit, bit 31 included.
The CUDA kernel reads the same memory as ``uint32_t``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PlanConfig:
    """Tile geometry for the block-CSR plan (field for field the JAX
    package's PlanConfig, so plans of both packages are comparable).

    block_h: rows of A per window.
    block_w: packed columns (lanes) per block.
    gather_segment: source-row coverage granularity; s > 1 covers each
        window's neighbour set with s-aligned runs of s consecutive rows.
    block_unroll: blocks per window are padded to a multiple of this.
    cluster_cols: sort each window's lanes by 128-row sub-window
        signature (format/cluster.py) and store the per-block occupancy
        in ``occ``; needs block_h % 128 == 0. Kernel K2 skips the
        sub-windows whose occupancy bit is clear.
    pack_order, seg_interleaved: TPU gather layouts the port does not
        build (ROADMAP.md item 18); kept so configs compare equal.
    """

    block_h: int = 128
    block_w: int = 128
    gather_segment: int = 1
    block_unroll: int = 1
    cluster_cols: bool = False
    pack_order: str = "natural"
    seg_interleaved: bool = False

    def __post_init__(self):
        if self.block_h <= 0 or self.block_w <= 0:
            raise ValueError(f"block_h and block_w must be positive: {self}")
        if self.gather_segment < 1 or self.block_w % self.gather_segment:
            raise ValueError(
                f"gather_segment must be >= 1 and divide block_w: {self}"
            )
        if self.block_unroll < 1:
            raise ValueError(f"block_unroll must be >= 1: {self}")
        if self.pack_order not in ("natural", "incidence"):
            raise ValueError(f"unknown pack_order {self.pack_order!r}")
        if self.pack_order == "incidence" and self.gather_segment == 1:
            raise ValueError("pack_order='incidence' only pays with gather_segment > 1")
        if self.seg_interleaved and (
            self.gather_segment == 1 or self.block_unroll % self.gather_segment
        ):
            raise ValueError(
                "seg_interleaved needs gather_segment > 1 dividing block_unroll"
            )
        if self.cluster_cols and self.block_h % 128:
            raise ValueError("cluster_cols needs block_h % 128 == 0")

    @property
    def words_per_col(self) -> int:
        """32-bit words needed to pack block_h row bits."""
        return -(-self.block_h // 32)


_TENSOR_FIELDS = (
    "bitmask", "hind", "window_of_block", "block_ptr", "occ", "values", "src_perm",
)


@dataclass
class SpmmPlan:
    bitmask: torch.Tensor  # int32 (total_blocks, words_per_col, block_w), uint32 bits
    hind: torch.Tensor  # int32 (total_blocks, block_w) gathered source rows
    window_of_block: torch.Tensor  # int32 (total_blocks,)
    block_ptr: torch.Tensor  # int32 (num_windows + 1,) exclusive block prefix
    config: PlanConfig
    num_nodes: int
    num_edges: int  # deduplicated nnz represented
    num_windows: int
    total_blocks: int
    has_empty_windows: bool = False  # any window with zero blocks
    num_cols: int | None = None  # source (column) space size; None = square
    # int32 (total_blocks,) carrying uint32 bits: bit s set iff 128-row
    # sub-window s of the block holds a bit (cluster_cols plans only)
    occ: torch.Tensor | None = None
    # float32 (total_blocks, block_h, block_w) value tiles of a weighted
    # plan (csr_preprocess(values=...)); ops.spmm runs K4 on it
    values: torch.Tensor | None = None
    # a layout of the JAX package the port does not build; refused by ops.spmm
    src_perm: torch.Tensor | None = None

    @property
    def padded_nodes(self) -> int:
        """Rows the windows cover before slicing back to num_nodes."""
        return self.num_windows * self.config.block_h

    @property
    def source_rows(self) -> int:
        """Rows of X this plan gathers from (column space of A)."""
        return self.num_cols if self.num_cols is not None else self.num_nodes

    @property
    def gather_rows(self) -> int:
        """Total X rows gathered per full pass."""
        return self.total_blocks * self.config.block_w

    @property
    def device(self) -> torch.device:
        return self.bitmask.device

    def to(self, device) -> "SpmmPlan":
        """A copy with every tensor on `device`. Move a plan once, when the
        graph is built: a request then finds it where its features are."""
        return dataclasses.replace(
            self,
            **{
                name: getattr(self, name).to(device)
                for name in _TENSOR_FIELDS
                if getattr(self, name) is not None
            },
        )

    def save(self, path: str, packed: bool = False) -> str:
        """Write the plan to one .npz in the JAX package's layout (a JSON
        header of the metadata beside the arrays), atomically through a
        per-process temporary file; return the path. Preprocess once, serve
        from many processes: a file of either package loads in the other.

        packed=True stores only the occupied 128-row bitmask sub-tiles
        (`bitmask_packed` and `bitmask_ids`, needs block_h % 128 == 0; a
        plan of other heights is written dense); `load` rebuilds the dense
        bitmask."""
        from .cluster import _bits_np, _host, pack_bitmask

        header = json.dumps(
            {
                "config": dataclasses.asdict(self.config),
                "num_nodes": self.num_nodes,
                "num_edges": self.num_edges,
                "num_windows": self.num_windows,
                "total_blocks": self.total_blocks,
                "has_empty_windows": self.has_empty_windows,
                "num_cols": self.num_cols,
            }
        )
        arrays = {
            "hind": _host(self.hind),
            "window_of_block": _host(self.window_of_block),
            "block_ptr": _host(self.block_ptr),
            "header": np.frombuffer(header.encode(), np.uint8),
        }
        # the JAX package writes uint32 bits; the port's int32 words carry them
        if packed and self.config.block_h % 128 == 0:
            pk, ids, _ = pack_bitmask(self.bitmask)
            arrays["bitmask_packed"] = pk
            arrays["bitmask_ids"] = ids
        else:
            arrays["bitmask"] = _bits_np(self.bitmask)
        if self.occ is not None:
            arrays["occ"] = _bits_np(self.occ)
        for name in ("values", "src_perm"):
            if getattr(self, name) is not None:
                arrays[name] = _host(getattr(self, name))
        if not path.endswith(".npz"):
            path += ".npz"
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp.removesuffix(".npz"), **arrays)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "SpmmPlan":
        """Read a plan written by `save` of either package, dense or packed,
        as CPU tensors (the bitmask and occ as int32 words carrying the
        uint32 bits); `to(device)` moves it."""
        from .cluster import unpack_bitmask_np

        def tensor(a, dtype=None):
            a = np.ascontiguousarray(a)
            return torch.from_numpy(a if dtype is None else a.view(dtype))

        with np.load(path) as z:
            meta = json.loads(bytes(z["header"]).decode())
            cfg = PlanConfig(**meta.pop("config"))
            if "bitmask_packed" in z:
                bitmask = unpack_bitmask_np(
                    z["bitmask_packed"], z["bitmask_ids"],
                    meta["total_blocks"], cfg.words_per_col, cfg.block_w,
                )
            else:
                bitmask = z["bitmask"]
            return cls(
                bitmask=tensor(bitmask, np.int32),
                hind=tensor(z["hind"]),
                window_of_block=tensor(z["window_of_block"]),
                block_ptr=tensor(z["block_ptr"]),
                config=cfg,
                occ=tensor(z["occ"], np.int32) if "occ" in z else None,
                values=tensor(z["values"]) if "values" in z else None,
                src_perm=tensor(z["src_perm"]) if "src_perm" in z else None,
                **meta,
            )

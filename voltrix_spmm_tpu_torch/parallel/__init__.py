"""Multi-rank execution on torch.distributed (counterpart of
voltrix_spmm_tpu/parallel/): SPMD sharding of SpMM and GCN training.

Each rank runs the same program on its own tensors (where the JAX package
has shard_map), over the process groups of a `DeviceMesh` (where it has a
Mesh); `comm` holds the collectives, their gradients and a launcher of
ranks (`comm.launch`). The modes:

- `sharded` (dp x tp): the batch over "data", Megatron-style tensor
  parallelism over "model";
- `row_sharded` / `row_sharded_gcn`: rows of one graph over an axis, an
  all-gather of X per layer (contiguous or degree-balanced shards);
- `ring`: the same rows, X travelling a ring while block SpMMs run;
- `hybrid`: an all-gather over hosts and a ring over a host's chips;
- `grid2d`: A cut over both axes of a ("row", "col") mesh.

Every block SpMM is K1 (`ops.spmm` / `ops.spmm_ad`) on the card, its plain
version on CPU tensors. `dryrun.dryrun_multichip` runs the five full-graph
and batched trainers against a dense oracle.
"""

from .grid2d import Grid2DPlan, build_grid2d_plan, grid2d_spmm, make_grid2d_train_step
from .hybrid import hybrid_sharded_spmm, make_hybrid_train_step
from .ring import RingShardedPlan, build_ring_sharded_plan, make_ring_train_step, ring_sharded_spmm
from .row_sharded import RowShardedPlan, build_row_sharded_plan, row_sharded_spmm
from .row_sharded_gcn import make_row_sharded_train_step
from .sharded import (
    gcn_param_specs,
    make_mesh,
    make_sharded_train_step,
    sharded_gcn_forward,
    sharded_spmm,
)

__all__ = [
    "Grid2DPlan",
    "build_grid2d_plan",
    "grid2d_spmm",
    "make_grid2d_train_step",
    "RingShardedPlan",
    "build_ring_sharded_plan",
    "ring_sharded_spmm",
    "make_ring_train_step",
    "hybrid_sharded_spmm",
    "make_hybrid_train_step",
    "make_mesh",
    "sharded_spmm",
    "sharded_gcn_forward",
    "make_sharded_train_step",
    "gcn_param_specs",
    "RowShardedPlan",
    "build_row_sharded_plan",
    "row_sharded_spmm",
    "make_row_sharded_train_step",
]

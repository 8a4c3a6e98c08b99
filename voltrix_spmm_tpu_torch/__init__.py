"""voltrix_spmm_tpu_torch: the PyTorch/CUDA port of voltrix_spmm_tpu.

The JAX package beside it is the reference; this package keeps its
module names and public layouts and runs on an NVIDIA H100 (sm_90a),
with each TPU kernel rewritten by hand in CUDA C++. It never imports
jax or voltrix_spmm_tpu.

  - ``csr_preprocess(indptr, indices, num_nodes, config) -> SpmmPlan``
  - ``spmm(plan, feat) -> out``  with ``out = A @ feat``
  - ``build_graph`` / ``gcn_forward`` / ``GCN``: the GCN serving path
"""

from . import project
from .format import PlanConfig, SpmmPlan, csr_preprocess
from .models import GCN, GraphData, build_graph, gcn_forward, gcn_params_from_jax
from .ops import spmm, spmm_ad, spmm_reference
from .utils import calc_diff, relative_error

__version__ = "0.1.0"

__all__ = [
    "PlanConfig",
    "SpmmPlan",
    "csr_preprocess",
    "spmm",
    "spmm_ad",
    "spmm_reference",
    "build_graph",
    "GraphData",
    "gcn_forward",
    "gcn_params_from_jax",
    "GCN",
    "calc_diff",
    "relative_error",
    "project",
]

from .gcn import GCN, gcn_forward, gcn_params_from_jax
from .graph import GraphData, aggregate, build_graph

__all__ = [
    "GCN",
    "GraphData",
    "aggregate",
    "build_graph",
    "gcn_forward",
    "gcn_params_from_jax",
]

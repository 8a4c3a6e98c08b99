from .gat import (
    GAT,
    GatGraph,
    build_gat_graph,
    edge_softmax,
    gat_attention_aggregate,
    gat_forward,
    gat_loss,
    gat_params_from_jax,
)
from .gcn import GCN, gcn_forward, gcn_loss, gcn_params_from_jax, make_train_step
from .graph import GraphData, aggregate, build_graph

__all__ = [
    "GAT",
    "GCN",
    "GatGraph",
    "GraphData",
    "aggregate",
    "build_gat_graph",
    "build_graph",
    "edge_softmax",
    "gat_attention_aggregate",
    "gat_forward",
    "gat_loss",
    "gat_params_from_jax",
    "gcn_forward",
    "gcn_loss",
    "gcn_params_from_jax",
    "make_train_step",
]

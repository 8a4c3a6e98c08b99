from .batching import block_diagonal, node_graph_ids, split_nodes
from .generate import (
    erdos_renyi_csr,
    load_npz_graph,
    reorder_auto,
    reorder_degree,
    reorder_rcm,
    rmat_csr,
    save_npz_graph,
    symmetrize,
    window_gather_volume,
)
from .real import (
    PUBLISHED,
    PublishedStats,
    chung_lu_csr,
    load_graph,
    load_tcgnn_npz,
    proxy_csr,
)
from .sampling import SampleBlock, block_caps, gather_features, sample_block, sample_blocks

__all__ = [
    "erdos_renyi_csr",
    "rmat_csr",
    "reorder_rcm",
    "reorder_degree",
    "reorder_auto",
    "window_gather_volume",
    "symmetrize",
    "save_npz_graph",
    "load_npz_graph",
    "SampleBlock",
    "sample_block",
    "sample_blocks",
    "gather_features",
    "block_caps",
    "block_diagonal",
    "node_graph_ids",
    "split_nodes",
    "PUBLISHED",
    "PublishedStats",
    "chung_lu_csr",
    "load_graph",
    "load_tcgnn_npz",
    "proxy_csr",
]

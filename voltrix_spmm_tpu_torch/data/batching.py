"""Block-diagonal batching of many small graphs (counterpart of
voltrix_spmm_tpu/data/batching.py).

A batch of graphs is one block-diagonal adjacency, so one SpMM serves the
whole batch; `node_graph_ids` gives each node its graph, the segment ids
of `models.graph_readout`, and `split_nodes` cuts a stacked node array
back into graphs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def block_diagonal(graphs: list[sp.csr_matrix]):
    """(big csr, node_offsets): node_offsets[i] is graph i's first node id
    (length len(graphs) + 1). Every graph must be square."""
    if not graphs:
        raise ValueError("need at least one graph")
    offsets = np.zeros(len(graphs) + 1, dtype=np.int64)
    for i, g in enumerate(graphs):
        if g.shape[0] != g.shape[1]:
            raise ValueError(f"graph {i} is not square: {g.shape}")
        offsets[i + 1] = offsets[i] + g.shape[0]
    big = sp.block_diag(graphs, format="csr")
    big.sum_duplicates()
    return big, offsets


def split_nodes(x, node_offsets):
    """Split a stacked node array (numpy or torch) back into per-graph arrays."""
    return [x[node_offsets[i]: node_offsets[i + 1]] for i in range(len(node_offsets) - 1)]


def node_graph_ids(node_offsets) -> np.ndarray:
    """Each node's graph id, int32 (total_nodes,), for a batch built by
    `block_diagonal`."""
    sizes = np.diff(np.asarray(node_offsets)).astype(np.int64)
    return np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)

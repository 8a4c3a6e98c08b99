"""Published dataset sizes and seeded stand-ins matched to them
(counterpart of voltrix_spmm_tpu/data/real.py).

`proxy_csr(name)` draws a Chung-Lu graph (plus community rewiring where
the dataset has it) with the published node and edge counts, from a
seed, so nothing is downloaded. It matches scale and skew, not the real
adjacency. `load_tcgnn_npz` reads the real files when a user has them, and
`load_graph` takes the real file where it is found and the proxy otherwise.
"""

from __future__ import annotations

import logging
import os
import zlib
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

logger = logging.getLogger("voltrix_torch")

DATASETS_DIR_FLAG = "VOLTRIX_TPU_DATASETS"  # the JAX package's variable, one directory for both


def load_tcgnn_npz(path: str) -> sp.csr_matrix:
    """Load a TC-GNN-format graph (npz with `src_li`, `dst_li`,
    `num_nodes`) or this repo's indptr/indices npz, as binary CSR with
    duplicate edges collapsed."""
    with np.load(path, allow_pickle=False) as z:
        keys = set(z.files)
        if {"src_li", "dst_li"} <= keys:
            src = np.asarray(z["src_li"]).reshape(-1).astype(np.int64)
            dst = np.asarray(z["dst_li"]).reshape(-1).astype(np.int64)
            n = int(z["num_nodes"]) if "num_nodes" in keys else int(
                max(src.max(), dst.max()) + 1
            )
            a = sp.csr_matrix(
                (np.ones(src.shape[0], np.float32), (src, dst)), shape=(n, n)
            )
            a.sum_duplicates()
            a.data[:] = 1.0
            return a
    if {"indptr", "indices"} <= keys:
        from .generate import load_npz_graph

        return load_npz_graph(path)
    raise ValueError(
        f"{path}: unrecognized graph npz (keys {sorted(keys)}); expected "
        "TC-GNN src_li/dst_li or indptr/indices"
    )


@dataclass(frozen=True)
class PublishedStats:
    num_nodes: int
    num_edges: int  # directed edge count as published
    kind: str  # "powerlaw" | "community" | "dense" | "mesh"
    note: str = ""


# Published sizes. Sources: GraphSAGE paper (reddit), OGB paper
# (ogbn-*, ddi), SNAP (amazon0505/0601, com-amazon, web-BerkStan),
# TC-GNN dataset table (DD, ppi, YeastH, Yeast).
PUBLISHED: dict[str, PublishedStats] = {
    "reddit": PublishedStats(232965, 114615892, "community",
                             "GraphSAGE; avg deg ~492, strong subreddit locality"),
    "ogbn-arxiv": PublishedStats(169343, 1166243, "powerlaw", "citation"),
    "ogbn-products": PublishedStats(2449029, 61859140, "community",
                                    "co-purchase; avg deg ~50"),
    "ddi": PublishedStats(4267, 1334889, "dense", "ogbl-ddi; ~7% density"),
    "amazon0505": PublishedStats(410236, 3356824, "powerlaw", "SNAP"),
    "amazon0601": PublishedStats(403394, 3387388, "powerlaw", "SNAP"),
    "com-amazon": PublishedStats(334863, 925872, "community", "SNAP"),
    "web-BerkStan": PublishedStats(685230, 7600595, "powerlaw", "SNAP web"),
    "ppi": PublishedStats(56944, 818716, "community", "GraphSAGE PPI"),
    "DD": PublishedStats(334925, 1686092, "mesh", "TC-GNN graph-kernel batch"),
    "YeastH": PublishedStats(3139988, 6487230, "mesh",
                             "TC-GNN graph-kernel batch (molecule components)"),
    "Yeast": PublishedStats(1714644, 3636546, "mesh",
                            "TC-GNN graph-kernel batch (molecule components)"),
    "FraudYelp-RSR": PublishedStats(45954, 7693958, "dense",
                                    "DGL FraudYelpDataset, R-S-R relation"),
    "protein": PublishedStats(132534, 39561252, "dense",
                              "proxied from ogbn-proteins (name ambiguous)"),
}


def chung_lu_csr(
    num_nodes: int,
    num_edges: int,
    alpha: float = 2.1,
    community: int | None = None,
    local_frac: float = 0.0,
    seed: int = 0,
) -> sp.csr_matrix:
    """Chung-Lu power-law graph: endpoints drawn with probability
    proportional to a Zipf(alpha) weight sequence; optionally a
    `local_frac` of edges is rewired inside `community`-sized node
    blocks to model community locality."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    p = w / w.sum()
    src = rng.choice(num_nodes, size=num_edges, p=p)
    dst = rng.choice(num_nodes, size=num_edges, p=p)
    if community and local_frac > 0:
        k = int(num_edges * local_frac)
        loc = rng.integers(0, num_edges, size=k)
        dst[loc] = (
            (src[loc] // community) * community
            + rng.integers(0, community, size=k)
        ) % num_nodes
    a = sp.csr_matrix(
        (np.ones(num_edges, np.float32), (src, dst)),
        shape=(num_nodes, num_nodes),
    )
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


def proxy_csr(name: str, seed: int = 0) -> sp.csr_matrix:
    """Seeded stand-in matched to `PUBLISHED[name]` node/edge counts and
    degree family. Not the real graph."""
    st = PUBLISHED[name]
    rng_seed = seed + (zlib.crc32(name.encode()) % 1000)  # stable across runs
    if st.kind == "dense":
        density = st.num_edges / (st.num_nodes**2)
        a = sp.random(
            st.num_nodes,
            st.num_nodes,
            density=density,
            format="csr",
            random_state=np.random.default_rng(rng_seed),
        )
        a.data[:] = 1.0
        return a
    if st.kind == "mesh":
        # graph-kernel batches: many small near-regular components
        return chung_lu_csr(
            st.num_nodes, st.num_edges, alpha=6.0,
            community=300, local_frac=0.95, seed=rng_seed,
        )
    local = 0.8 if st.kind == "community" else 0.0
    comm = 512 if st.kind == "community" else None
    return chung_lu_csr(
        st.num_nodes, st.num_edges, alpha=2.1,
        community=comm, local_frac=local, seed=rng_seed,
    )


def load_graph(name: str, data_dir: str | None = None) -> tuple[sp.csr_matrix, str]:
    """The graph `<data_dir>/<name>.npz` (TC-GNN or this repo's layout) if
    the file is there, else `proxy_csr(name)`; returns (csr, label), the
    label `name` for the real file and `<name>-proxy` for the stand-in.
    data_dir defaults to $VOLTRIX_TPU_DATASETS, else ./datasets. Nothing
    is downloaded; a name without a file or PUBLISHED stats raises."""
    data_dir = data_dir or os.environ.get(DATASETS_DIR_FLAG, "datasets")
    path = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(path):
        return load_tcgnn_npz(path), name
    if name not in PUBLISHED:
        raise FileNotFoundError(
            f"{path} not found and no published stats for {name!r} (put the .npz "
            f"in ${DATASETS_DIR_FLAG} or pass data_dir)"
        )
    logger.warning("%s: %s not found; using the published-stats proxy", name, path)
    return proxy_csr(name), f"{name}-proxy"

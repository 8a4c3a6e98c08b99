from .generate import (
    erdos_renyi_csr,
    load_npz_graph,
    rmat_csr,
    symmetrize,
)
from .real import PUBLISHED, PublishedStats, chung_lu_csr, load_tcgnn_npz, proxy_csr

__all__ = [
    "erdos_renyi_csr",
    "rmat_csr",
    "symmetrize",
    "load_npz_graph",
    "PUBLISHED",
    "PublishedStats",
    "chung_lu_csr",
    "load_tcgnn_npz",
    "proxy_csr",
]

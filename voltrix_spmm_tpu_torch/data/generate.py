"""Seeded synthetic graphs (counterpart of voltrix_spmm_tpu/data/generate.py).

The same numpy and scipy code, so a seed gives the same graph in both
packages.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def erdos_renyi_csr(num_nodes: int, density: float, seed: int = 0) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    a = sp.random(
        num_nodes, num_nodes, density=density, format="csr", random_state=rng
    )
    a.data[:] = 1.0
    return a


def rmat_csr(
    scale: int,
    avg_degree: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> sp.csr_matrix:
    """R-MAT graph with 2**scale nodes and ~avg_degree edges per node."""
    n = 1 << scale
    nnz = n * avg_degree
    rng = np.random.default_rng(seed)
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    for _ in range(scale):
        p = rng.random(nnz)
        # quadrant probabilities (a | b / c | d)
        rbit = (p >= a + b).astype(np.int64)
        cbit = (((p >= a) & (p < a + b)) | (p >= a + b + c)).astype(np.int64)
        rows = rows * 2 + rbit
        cols = cols * 2 + cbit
    m = sp.csr_matrix(
        (np.ones(nnz, dtype=np.float32), (rows, cols)), shape=(n, n)
    )
    m.sum_duplicates()
    m.data[:] = 1.0
    return m


def symmetrize(a: sp.csr_matrix) -> sp.csr_matrix:
    s = ((a + a.T) != 0).astype(np.float32).tocsr()
    s.sum_duplicates()
    return s


def load_npz_graph(path: str) -> sp.csr_matrix:
    with np.load(path) as z:
        return sp.csr_matrix(
            (np.ones(int(z["nnz"]), np.float32), z["indices"], z["indptr"]),
            shape=(int(z["num_nodes"]), int(z["num_nodes"])),
        )

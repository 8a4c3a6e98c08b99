"""Seeded synthetic graphs, the graph .npz files and locality reorders
(counterpart of voltrix_spmm_tpu/data/generate.py).

The same numpy and scipy code, so a seed gives the same graph, and a
graph the same reorder, in both packages.
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


def save_npz_graph(path: str, a: sp.csr_matrix) -> str:
    """Write a graph as the .npz of `load_npz_graph` (indptr, indices,
    num_nodes, nnz); returns `path`."""
    np.savez_compressed(
        path,
        indptr=a.indptr.astype(np.int32),
        indices=a.indices.astype(np.int32),
        num_nodes=np.int64(a.shape[0]),
        nnz=np.int64(a.nnz),
    )
    return path


def load_npz_graph(path: str) -> sp.csr_matrix:
    with np.load(path) as z:
        return sp.csr_matrix(
            (np.ones(int(z["nnz"]), np.float32), z["indices"], z["indptr"]),
            shape=(int(z["num_nodes"]), int(z["num_nodes"])),
        )


def reorder_rcm(a: sp.csr_matrix) -> tuple[sp.csr_matrix, np.ndarray]:
    """Reverse Cuthill-McKee reorder; returns (reordered csr, permutation)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = reverse_cuthill_mckee(a, symmetric_mode=False)
    a2 = a[perm][:, perm].tocsr()
    a2.sort_indices()
    return a2, perm


def reorder_degree(a: sp.csr_matrix) -> tuple[sp.csr_matrix, np.ndarray]:
    """Degree-descending reorder (stable among equal degrees): hub
    neighbours land in few windows, where a window gathers each once."""
    deg = np.asarray(a.sum(axis=1)).ravel()
    perm = np.argsort(-deg, kind="stable")
    a2 = a[perm][:, perm].tocsr()
    a2.sort_indices()
    return a2, perm


def window_gather_volume(a: sp.csr_matrix, block_h: int = 1024) -> int:
    """Sum over windows of block_h rows of their distinct neighbour
    columns: the X rows a plan with this window height gathers."""
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    key = (rows // block_h) * n + a.indices.astype(np.int64)
    return int(np.unique(key).shape[0])


def reorder_auto(
    a: sp.csr_matrix,
    block_h: int = 1024,
    candidates: tuple[str, ...] = ("rcm",),
) -> tuple[sp.csr_matrix, np.ndarray, str]:
    """The ordering among identity and `candidates` ("rcm", "degree") with
    the least `window_gather_volume`; returns (csr, permutation, name).
    Gather volume is a proxy of the SpMM's time, not its measurement."""
    n = a.shape[0]
    fns = {"rcm": reorder_rcm, "degree": reorder_degree}
    best = (window_gather_volume(a, block_h), a, np.arange(n), "identity")
    for name in candidates:
        a2, perm = fns[name](a)
        vol = window_gather_volume(a2, block_h)
        if vol < best[0]:
            best = (vol, a2, perm, name)
    return best[1], best[2], best[3]

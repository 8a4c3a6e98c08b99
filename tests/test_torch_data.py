"""Parity of the PyTorch port's data helpers with the JAX package: locality
reorders, window gather volume, the graph .npz files and `load_graph`.
Both packages run the same numpy and scipy code, so results are equal."""

import numpy as np
import pytest
import scipy.sparse as sp

import voltrix_spmm_tpu.data as jdata
import voltrix_spmm_tpu.data.real as jreal
import voltrix_spmm_tpu_torch.data as tdata
import voltrix_spmm_tpu_torch.data.real as treal


def graphs():
    return {
        "rmat": tdata.symmetrize(tdata.rmat_csr(10, avg_degree=8, seed=1)),
        "chung-lu": tdata.symmetrize(tdata.chung_lu_csr(1500, 6000, seed=2)),
        "directed": tdata.erdos_renyi_csr(700, 0.01, seed=3),
    }


def assert_same_csr(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("name", ["rmat", "chung-lu", "directed"])
@pytest.mark.parametrize("reorder", ["reorder_rcm", "reorder_degree"])
def test_reorders_match_jax(name, reorder):
    a = graphs()[name]
    a_t, perm_t = getattr(tdata, reorder)(a)
    a_j, perm_j = getattr(jdata, reorder)(a)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert_same_csr(a_t, a_j)
    assert sorted(perm_t.tolist()) == list(range(a.shape[0]))


@pytest.mark.parametrize("name", ["rmat", "chung-lu", "directed"])
@pytest.mark.parametrize("block_h", [32, 128, 1024])
def test_window_gather_volume_matches_jax(name, block_h):
    a = graphs()[name]
    vol = tdata.window_gather_volume(a, block_h)
    assert vol == jdata.window_gather_volume(a, block_h)
    # against its definition, window by window
    want = sum(len(np.unique(a[r:r + block_h].indices)) for r in range(0, a.shape[0], block_h))
    assert vol == want


@pytest.mark.parametrize("candidates", [("rcm",), ("rcm", "degree"), ()])
def test_reorder_auto_matches_jax(candidates):
    a = graphs()["rmat"]
    a_t, perm_t, name_t = tdata.reorder_auto(a, 128, candidates)
    a_j, perm_j, name_j = jdata.reorder_auto(a, 128, candidates)
    assert name_t == name_j
    np.testing.assert_array_equal(perm_t, perm_j)
    assert_same_csr(a_t, a_j)
    if not candidates:
        assert name_t == "identity"


def test_save_npz_graph_round_trip_across_packages(tmp_path):
    a = graphs()["chung-lu"]
    p_t = tdata.save_npz_graph(str(tmp_path / "t.npz"), a)
    p_j = jdata.save_npz_graph(str(tmp_path / "j.npz"), a)
    assert p_t == str(tmp_path / "t.npz")
    with np.load(p_t) as zt, np.load(p_j) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype
            np.testing.assert_array_equal(zt[k], zj[k])
    assert_same_csr(tdata.load_npz_graph(p_t), jdata.load_npz_graph(p_j))
    assert_same_csr(tdata.load_npz_graph(p_j), a)


def test_load_graph_reads_the_file(tmp_path):
    a = graphs()["directed"]
    tdata.save_npz_graph(str(tmp_path / "mygraph.npz"), a)
    got, label = tdata.load_graph("mygraph", str(tmp_path))
    want, label_j = jdata.load_graph("mygraph", str(tmp_path))
    assert label == label_j == "mygraph"
    assert_same_csr(got, want)
    # the TC-GNN layout: edge lists
    coo = a.tocoo()
    np.savez(tmp_path / "edges.npz", src_li=coo.row, dst_li=coo.col, num_nodes=a.shape[0])
    got, label = tdata.load_graph("edges", str(tmp_path))
    assert label == "edges"
    assert_same_csr(got, jdata.load_graph("edges", str(tmp_path))[0])


def test_load_graph_falls_back_to_the_proxy(tmp_path, monkeypatch):
    small = dict(num_nodes=900, num_edges=4000, kind="powerlaw")
    monkeypatch.setitem(treal.PUBLISHED, "tiny", treal.PublishedStats(**small))
    monkeypatch.setitem(jreal.PUBLISHED, "tiny", jreal.PublishedStats(**small))
    got, label = tdata.load_graph("tiny", str(tmp_path))
    want, label_j = jdata.load_graph("tiny", str(tmp_path))
    assert label == label_j == "tiny-proxy"
    assert_same_csr(got, want)
    monkeypatch.setenv(treal.DATASETS_DIR_FLAG, str(tmp_path))
    assert_same_csr(tdata.load_graph("tiny")[0], got)


def test_load_graph_refuses_unknown_names(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdata.load_graph("no-such-graph", str(tmp_path))


def test_reorder_preserves_the_graph():
    a = graphs()["chung-lu"]
    for fn in (tdata.reorder_rcm, tdata.reorder_degree):
        a2, perm = fn(a)
        back = sp.csr_matrix(a2)[np.argsort(perm)][:, np.argsort(perm)].tocsr()
        back.sort_indices()
        assert_same_csr(back, a)

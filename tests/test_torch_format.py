"""Parity of the PyTorch port's plan format and data generators with the
JAX package: the same CSR gives the same plan arrays bit for bit, and the
same seed gives the same graph."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.data as jdata
import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.format.preprocess as jpre
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.data as tdata
import voltrix_spmm_tpu_torch.format as tfmt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_spmm.py:36-45, then the cases the port's kernel must also get right
GEOMETRIES = [
    (512, 0.05, dict(block_h=128, block_w=128)),
    (300, 0.02, dict(block_h=32, block_w=128)),
    (1000, 0.01, dict(block_h=128, block_w=256)),
    (512, 0.05, dict(block_h=32, block_w=128, block_unroll=4)),
    (400, 0.03, dict(block_h=32, block_w=128, gather_segment=8, block_unroll=2)),
    (1001, 0.01, dict(block_h=128, block_w=128, gather_segment=4)),
    (700, 0.02, dict(block_h=48, block_w=128)),
]


def random_csr(n, density, seed, num_cols=None):
    a = sp.random(n, num_cols or n, density=density, format="csr",
                  random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a


def drop_rows(a, keep):
    """`a` with every row r for which keep(r) is false emptied."""
    mask = np.array([keep(r) for r in range(a.shape[0])], dtype=np.float32)
    return (sp.diags(mask) @ a).tocsr()


def both_plans(a, num_nodes, num_cols=None, **cfg):
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, num_nodes, jfmt.PlanConfig(**cfg),
                                backend="numpy", num_cols=num_cols)
    tplan = vt.csr_preprocess(a.indptr, a.indices, num_nodes, vt.PlanConfig(**cfg),
                              num_cols=num_cols)
    return jplan, tplan


def assert_same_plan(jplan, tplan):
    assert tplan.bitmask.dtype == torch.int32  # uint32 bits, see format/plan.py
    np.testing.assert_array_equal(tplan.bitmask.numpy().view(np.uint32), jplan.bitmask)
    for name in ("hind", "window_of_block", "block_ptr"):
        t = getattr(tplan, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jplan, name)), err_msg=name)
    for name in ("num_nodes", "num_edges", "num_windows", "total_blocks",
                 "has_empty_windows", "num_cols", "padded_nodes", "source_rows",
                 "gather_rows"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    assert dataclasses.asdict(tplan.config) == dataclasses.asdict(jplan.config)


def test_import_leaves_out_jax():
    code = ("import sys, voltrix_spmm_tpu_torch, voltrix_spmm_tpu_torch.format.ell, "
            "voltrix_spmm_tpu_torch.ops.ell, voltrix_spmm_tpu_torch.models.gat_ell, "
            "voltrix_spmm_tpu_torch.models.linkpred; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('voltrix_spmm_tpu') and not m.startswith('voltrix_spmm_tpu_torch')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_plan_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jfmt.PlanConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(vt.PlanConfig)]
    assert tf == jf
    assert vt.PlanConfig(48, 128).words_per_col == jfmt.PlanConfig(48, 128).words_per_col == 2


@pytest.mark.parametrize("n,density,cfg", GEOMETRIES)
def test_plan_bit_identical(n, density, cfg):
    a = random_csr(n, density, seed=n)
    jplan, tplan = both_plans(a, n, **cfg)
    assert_same_plan(jplan, tplan)


def test_plan_bit_31_set():
    n = 1024
    jplan, tplan = both_plans(random_csr(n, 0.02, seed=3), n, block_h=128, block_w=128)
    assert bool((tplan.bitmask < 0).any())  # some word has bit 31 set
    assert_same_plan(jplan, tplan)


def test_plan_empty_windows_padded():
    n = 2048
    a = drop_rows(random_csr(n, 0.01, seed=5), lambda r: not 256 <= r < 512)
    jplan, tplan = both_plans(a, n, block_h=128, block_w=128)
    # two empty windows get zero-bit padding blocks: no window is left empty
    assert not tplan.has_empty_windows
    assert bool((tplan.bitmask.reshape(tplan.total_blocks, -1) == 0).all(1).any())
    assert_same_plan(jplan, tplan)


def test_plan_empty_windows_left_without_blocks():
    n = 2048
    # 63 of 64 windows empty: padding them would outnumber the real blocks
    a = drop_rows(random_csr(n, 0.01, seed=6), lambda r: r < 32)
    jplan, tplan = both_plans(a, n, block_h=32, block_w=128, block_unroll=2)
    assert tplan.has_empty_windows
    assert_same_plan(jplan, tplan)


def test_plan_empty_matrix():
    n = 300
    jplan, tplan = both_plans(random_csr(n, 0.0, seed=7), n, block_h=128, block_w=128)
    assert tplan.total_blocks == 0 and tuple(tplan.bitmask.shape) == (0, 4, 128)
    assert_same_plan(jplan, tplan)


def test_plan_rectangular():
    a = random_csr(500, 0.02, seed=8, num_cols=900)
    jplan, tplan = both_plans(a, 500, num_cols=900, block_h=64, block_w=128)
    assert tplan.source_rows == 900
    assert_same_plan(jplan, tplan)


def test_plan_to_dense_and_stats_match():
    n = 700
    a = random_csr(n, 0.02, seed=9)
    jplan, tplan = both_plans(a, n, block_h=48, block_w=128)
    dense = tfmt.plan_to_dense(tplan)
    np.testing.assert_array_equal(dense, jfmt.plan_to_dense(jplan))
    np.testing.assert_array_equal(dense, (a.toarray() != 0).astype(np.uint8))
    assert tfmt.plan_stats(tplan) == jfmt.plan_stats(jplan)
    np.testing.assert_array_equal(
        tfmt.expand_bitmask_np(tplan.bitmask, 48),
        jfmt.expand_bitmask_np(jplan.bitmask, 48),
    )


@pytest.mark.parametrize("bpw,unroll", [
    ([3, 0, 2, 0], 1),           # cheap: the empty windows get padding blocks
    ([0] * 70 + [1], 1),         # empty windows dominate: left as they are
    ([4, 0, 8, 0, 4], 4),
    ([5, 6, 7], 2),              # no empty window
])
def test_pad_empty_windows_matches(bpw, unroll):
    bpw = np.asarray(bpw, dtype=np.int64)
    np.testing.assert_array_equal(
        tfmt.pad_empty_windows(bpw, unroll), jpre.pad_empty_windows(bpw, unroll)
    )


def test_plan_to_moves_every_tensor():
    n = 512
    _, tplan = both_plans(random_csr(n, 0.05, seed=10), n)
    moved = tplan.to("meta")
    for name in ("bitmask", "hind", "window_of_block", "block_ptr"):
        assert getattr(moved, name).device.type == "meta", name
        assert getattr(tplan, name).device.type == "cpu", name
    assert moved.device.type == "meta"
    assert moved.occ is None and moved.values is None and moved.src_perm is None
    assert (moved.config, moved.num_nodes, moved.total_blocks) == (
        tplan.config, tplan.num_nodes, tplan.total_blocks)


@pytest.mark.parametrize("kwargs,cfg", [
    (dict(backend="native"), {}),
    (dict(values=True), dict(block_h=128, gather_segment=8)),
    (dict(values=True), dict(block_h=128, cluster_cols=True)),
    ({}, dict(gather_segment=4, pack_order="incidence")),
    ({}, dict(gather_segment=2, block_unroll=2, seg_interleaved=True)),
])
def test_preprocess_refuses_unported(kwargs, cfg):
    """Layouts the port does not build are refused naming their ROADMAP
    item; weighted plans without exact lanes are refused as the JAX
    package refuses them (values alone build: tests/test_torch_weighted.py)."""
    a = random_csr(256, 0.05, seed=11)
    if kwargs.get("values"):
        kwargs = dict(values=np.ones(a.nnz, np.float32))
        with pytest.raises(AssertionError):
            jfmt.csr_preprocess(a.indptr, a.indices, 256, jfmt.PlanConfig(**cfg), **kwargs)
        with pytest.raises(ValueError, match="weighted plans"):
            vt.csr_preprocess(a.indptr, a.indices, 256, vt.PlanConfig(**cfg), **kwargs)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
        vt.csr_preprocess(a.indptr, a.indices, 256, vt.PlanConfig(**cfg), **kwargs)


@pytest.mark.parametrize("keys", [
    np.zeros(0, np.int64), np.array([7], np.int64), np.array([3, 3, 3], np.int64),
    np.random.default_rng(13).integers(0, 500, 4000),
])
def test_sorted_unique_matches_np_unique(keys):
    from voltrix_spmm_tpu_torch.format.preprocess import _sorted_unique

    got = _sorted_unique(keys.copy())
    assert got.dtype == keys.dtype
    np.testing.assert_array_equal(got, np.unique(keys))


def test_preprocess_rejects_bad_csr():
    with pytest.raises(ValueError, match="bad CSR"):
        vt.csr_preprocess(np.zeros(5, np.int64), np.zeros(0, np.int64), 10)


def assert_same_csr(x, y):
    assert x.shape == y.shape
    np.testing.assert_array_equal(x.indptr, y.indptr)
    np.testing.assert_array_equal(x.indices, y.indices)
    np.testing.assert_array_equal(x.data, y.data)


def test_proxy_ogbn_arxiv_same_graph():
    t, j = tdata.proxy_csr("ogbn-arxiv"), jdata.proxy_csr("ogbn-arxiv")
    assert t.shape == (169343, 169343)
    assert_same_csr(t, j)
    assert_same_csr(tdata.symmetrize(t), jdata.symmetrize(j))
    assert tdata.PUBLISHED == {k: tdata.PublishedStats(*dataclasses.astuple(v))
                               for k, v in jdata.PUBLISHED.items()}


@pytest.mark.parametrize("name", ["ddi", "ppi"])
def test_proxy_other_families_same_graph(name):
    # "dense" and "community" generator families at their smallest sizes
    assert_same_csr(tdata.proxy_csr(name, seed=1), jdata.proxy_csr(name, seed=1))


@pytest.mark.parametrize("gen,args", [
    ("erdos_renyi_csr", (1500, 0.01, 4)),
    ("rmat_csr", (10, 8)),
    ("chung_lu_csr", (3000, 20000)),
])
def test_generators_same_graph(gen, args):
    t, j = getattr(tdata, gen)(*args), getattr(jdata, gen)(*args)
    assert_same_csr(t, j)
    assert_same_csr(tdata.symmetrize(t), jdata.symmetrize(j))


def test_load_tcgnn_npz_matches(tmp_path):
    rng = np.random.default_rng(12)
    src = rng.integers(0, 400, 3000)
    dst = rng.integers(0, 400, 3000)
    path = str(tmp_path / "g.npz")
    np.savez(path, src_li=src, dst_li=dst, num_nodes=np.int64(400))
    assert_same_csr(tdata.load_tcgnn_npz(path), jdata.load_tcgnn_npz(path))
    path2 = jdata.save_npz_graph(str(tmp_path / "h.npz"), jdata.erdos_renyi_csr(300, 0.02))
    assert_same_csr(tdata.load_tcgnn_npz(path2), jdata.load_tcgnn_npz(path2))

"""Parity of the PyTorch port's column clustering (format/cluster.py) and
of kernel K2's plain version with the JAX package on the CPU.

Clustered plans must be bit-identical, `occ` included. The port's
`spmm(..., subtile=True)` runs K2's plain version on a CPU tensor; the JAX
side runs `spmm_pallas(subtile=True)` in interpret mode, as
tests/test_cluster.py does. Output tolerances are those of
tests/test_spmm.py:51-52 (float32 sums taken in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.format.cluster as jcluster
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.format.cluster as tcluster
from voltrix_spmm_tpu.ops.pallas_spmm import _subtile_occupancy
from voltrix_spmm_tpu_torch.ops import (
    spmm_reference, spmm_scipy, spmm_subtile, spmm_subtile_reference,
)
from voltrix_spmm_tpu_torch.ops.subtile_spmm import group_keep, subtile_occupancy

TOL = dict(rtol=1e-5, atol=1e-4)


def community_csr(n, seed, comm=128, num_cols=None):
    """Rows whose neighbours mostly share one 128-row band (so clustering
    has bite), plus uniform noise: the graph of tests/test_cluster.py."""
    rng = np.random.default_rng(seed)
    span = num_cols or n
    src = rng.integers(0, n, size=n * 8)
    dst = ((src // comm) * comm + rng.integers(0, comm, size=src.shape[0])) % span
    src = np.concatenate([src, rng.integers(0, n, size=n)])
    dst = np.concatenate([dst, rng.integers(0, span, size=n)])
    a = sp.csr_matrix((np.ones(src.shape[0], np.float32), (src, dst)), shape=(n, span))
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


def drop_rows(a, keep):
    mask = np.array([keep(r) for r in range(a.shape[0])], dtype=np.float32)
    return (sp.diags(mask) @ a).tocsr()


def both_plans(a, num_cols=None, **cfg):
    n = a.shape[0]
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, n, jfmt.PlanConfig(**cfg),
                                backend="numpy", num_cols=num_cols)
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg), num_cols=num_cols)
    return jplan, tplan


def assert_same_plan(jplan, tplan):
    np.testing.assert_array_equal(tplan.bitmask.numpy().view(np.uint32), jplan.bitmask)
    for name in ("hind", "window_of_block", "block_ptr", "occ"):
        t = getattr(tplan, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jplan, name)), err_msg=name)
    for name in ("num_nodes", "num_edges", "num_windows", "total_blocks",
                 "has_empty_windows", "num_cols", "source_rows"):
        assert getattr(tplan, name) == getattr(jplan, name), name


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def assert_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert vt.calc_diff(out, ref) < 1e-6
    np.testing.assert_allclose(out, ref, **TOL)


# the K2 geometries chip_smoke.py holds the kernel to
K2_GEOMETRIES = [(h, u) for h in (128, 256, 512, 2048) for u in (1, 4)]


@pytest.mark.parametrize("block_h,unroll", K2_GEOMETRIES)
def test_clustered_plan_bit_identical(block_h, unroll):
    a = community_csr(3000, seed=block_h + unroll)
    jplan, tplan = both_plans(a, block_h=block_h, block_unroll=unroll, cluster_cols=True)
    assert tplan.occ.shape == (tplan.total_blocks,)
    assert_same_plan(jplan, tplan)


@pytest.mark.parametrize("case", ["gather_segment_2", "rectangular", "empty_matrix",
                                  "empty_windows_padded", "empty_windows_left"])
def test_clustered_plan_edge_cases_bit_identical(case):
    num_cols = None
    cfg = dict(block_h=256, block_unroll=2, cluster_cols=True)
    if case == "gather_segment_2":
        a, cfg = community_csr(1500, seed=1), dict(block_h=256, gather_segment=2, cluster_cols=True)
    elif case == "rectangular":
        num_cols = 1700
        a = community_csr(1200, seed=2, num_cols=num_cols)
    elif case == "empty_matrix":
        a = sp.csr_matrix((300, 300), dtype=np.float32)
    elif case == "empty_windows_padded":
        a, cfg = drop_rows(community_csr(2048, seed=3), lambda r: not 256 <= r < 512), \
            dict(block_h=128, cluster_cols=True)
    else:
        a, cfg = drop_rows(community_csr(10240, seed=4), lambda r: r < 128), \
            dict(block_h=128, cluster_cols=True)
    jplan, tplan = both_plans(a, num_cols=num_cols, **cfg)
    assert_same_plan(jplan, tplan)
    if case == "empty_matrix":
        assert tplan.total_blocks == 0 and tuple(tplan.occ.shape) == (0,)
    if case == "empty_windows_left":
        assert tplan.has_empty_windows
    if case == "empty_windows_padded":
        assert not tplan.has_empty_windows and bool((tplan.occ == 0).any())


def test_cluster_helpers_match_jax():
    a = community_csr(2500, seed=5)
    jplan, tplan = both_plans(a, block_h=512, block_unroll=2)  # not yet clustered
    bm = np.asarray(jplan.bitmask)
    np.testing.assert_array_equal(tcluster.lane_signatures(tplan.bitmask), jcluster.lane_signatures(bm))
    np.testing.assert_array_equal(tcluster.block_occupancy(tplan.bitmask), jcluster.block_occupancy(bm))
    assert tcluster.subtile_stats(tplan) == jcluster.subtile_stats(jplan)
    tc, jc = tcluster.cluster_window_columns(tplan), jcluster.cluster_window_columns(jplan)
    np.testing.assert_array_equal(tc.bitmask.numpy().view(np.uint32), jc.bitmask)
    np.testing.assert_array_equal(tc.hind.numpy(), jc.hind)
    # clustering only moves lanes: the same matrix, fewer occupied sub-windows
    np.testing.assert_array_equal(vt.format.plan_to_dense(tc), vt.format.plan_to_dense(tplan))
    assert (tcluster.subtile_stats(tc)["occupied_subtiles"]
            < tcluster.subtile_stats(tplan)["occupied_subtiles"])
    with pytest.raises(ValueError, match="block_h % 128"):
        tcluster.cluster_window_columns(both_plans(a, block_h=64)[1])


def test_pack_bitmask_round_trip_matches_jax():
    a = sp.random(800, 800, density=0.004, format="csr", random_state=np.random.default_rng(6))
    jplan, tplan = both_plans(a, block_h=256, block_unroll=2, cluster_cols=True)
    packed, ids, nsub = tcluster.pack_bitmask(tplan.bitmask)
    jpacked, jids, jnsub = jcluster.pack_bitmask(np.asarray(jplan.bitmask))
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(ids, jids)
    assert nsub == jnsub == 2 and packed.dtype == np.uint32
    tb = tplan.total_blocks
    np.testing.assert_array_equal(tcluster.unpack_bitmask_np(packed, ids, tb, 8, 128), jplan.bitmask)
    dense = tcluster.unpack_bitmask(packed, ids, tb, 8, 128, device="cpu")
    assert dense.dtype == torch.int32 and torch.equal(dense, tplan.bitmask)


def test_block_occupancy_on_device_matches_jax():
    a = community_csr(5000, seed=7)
    jplan, tplan = both_plans(a, block_h=4096, block_unroll=2)  # 32 sub-windows: bit 31
    occ = subtile_occupancy(tplan.bitmask)
    assert occ.dtype == torch.int32 and bool((occ < 0).any())
    np.testing.assert_array_equal(occ.numpy(), tcluster.block_occupancy(tplan.bitmask))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(_subtile_occupancy(jnp.asarray(jplan.bitmask), 2)))


def test_group_keep_is_the_or_over_each_unroll_group():
    occ = torch.tensor([0b0001, 0b0100, 0, 0, 0b1000, 0, 0, -2**31], dtype=torch.int32)
    keep = group_keep(occ, unroll=4, nsub=32)
    assert keep.shape == (8, 32)
    want0 = torch.zeros(32)
    want0[[0, 2]] = 1
    want1 = torch.zeros(32)
    want1[[3, 31]] = 1
    assert torch.equal(keep[:4], want0.expand(4, 32))
    assert torch.equal(keep[4:], want1.expand(4, 32))


# (n, d, config): the K2 geometries at an unaligned d, then the port's edges
K2_SPMM_CASES = [
    (3000, 72, dict(block_h=128, block_unroll=1)),
    (3000, 96, dict(block_h=256, block_unroll=4)),
    (3000, 40, dict(block_h=512, block_unroll=1)),
    (5000, 100, dict(block_h=2048, block_unroll=4)),
    (1500, 64, dict(block_h=256, gather_segment=2)),
]


@pytest.mark.parametrize("n,d,cfg", K2_SPMM_CASES)
def test_subtile_spmm_matches_jax(n, d, cfg):
    a = community_csr(n, seed=n + d)
    jplan, tplan = both_plans(a, cluster_cols=True, **cfg)
    x = features(n, d, seed=8)
    ref = np.asarray(jops.spmm_pallas(jplan, jnp.asarray(x), subtile=True))
    calls = spmm_subtile_reference.calls
    out = vt.spmm(tplan, torch.from_numpy(x), subtile=True)
    assert spmm_subtile_reference.calls == calls + 1
    assert_close(out, ref)
    assert_close(out, spmm_scipy(a.indptr, a.indices, n, x))
    # without the plan's occ, the occupancy is read from the bitmask
    assert_close(spmm_subtile(dataclasses.replace(tplan, occ=None), torch.from_numpy(x)), ref)


@pytest.mark.parametrize("case", ["empty_matrix", "empty_windows_left"])
def test_subtile_spmm_empty_matches_jax(case):
    n, d = 10240, 48
    if case == "empty_matrix":
        a = sp.csr_matrix((n, n), dtype=np.float32)
    else:
        a = drop_rows(community_csr(n, seed=9), lambda r: r < 128)
    jplan, tplan = both_plans(a, block_h=128, cluster_cols=True)
    assert tplan.has_empty_windows
    x = features(n, d, seed=9)
    out = vt.spmm(tplan, torch.from_numpy(x), subtile=True)
    assert_close(out, np.asarray(jops.spmm_pallas(jplan, jnp.asarray(x), subtile=True)))
    assert_close(out, spmm_scipy(a.indptr, a.indices, n, x))


def test_cleared_occupancy_bit_truncates_as_jax_does():
    """An occ bit cleared on purpose (unroll 1) drops that sub-window of
    that block in the TPU kernel and in K2's plain version alike."""
    n, d = 2048, 32
    a = community_csr(n, seed=10)
    jplan, tplan = both_plans(a, block_h=512, cluster_cols=True)
    b = int(np.flatnonzero(np.asarray(jplan.occ) & 0b10)[0])  # a block with sub-window 1
    jocc = np.array(jplan.occ)
    jocc[b] &= ~0b10
    jcut = dataclasses.replace(jplan, occ=jocc)
    tcut = dataclasses.replace(tplan, occ=torch.from_numpy(jocc.copy()))
    x = features(n, d, seed=10)
    ref = np.asarray(jops.spmm_pallas(jcut, jnp.asarray(x), subtile=True))
    out = vt.spmm(tcut, torch.from_numpy(x), subtile=True).numpy()
    assert_close(out, ref)
    full = spmm_scipy(a.indptr, a.indices, n, x)
    w = int(tplan.window_of_block[b])
    rows = slice(w * 512 + 128, w * 512 + 256)
    assert not np.allclose(out[rows], full[rows], **TOL)  # the cut rows lost block b
    keep = np.ones(n, bool)
    keep[rows] = False
    np.testing.assert_allclose(out[keep], full[keep], **TOL)


def test_clustered_plan_without_subtile_runs_k1():
    """As in JAX, ops.spmm on a clustered plan without subtile=True runs
    the block SpMM (K1), not K2."""
    n, d = 1500, 24
    a = community_csr(n, seed=11)
    jplan, tplan = both_plans(a, block_h=256, cluster_cols=True)
    x = features(n, d, seed=11)
    k1, k2 = spmm_reference.calls, spmm_subtile_reference.calls
    out = vt.spmm(tplan, torch.from_numpy(x))
    assert (spmm_reference.calls, spmm_subtile_reference.calls) == (k1 + 1, k2)
    assert_close(out, np.asarray(jops.spmm_pallas(jplan, jnp.asarray(x))))


def test_subtile_refuses_plans_it_does_not_take():
    a = community_csr(600, seed=12)
    _, tplan = both_plans(a, block_h=64)
    with pytest.raises(ValueError, match="block_h % 128"):
        spmm_subtile_reference(tplan, torch.zeros(600, 8))
    _, tplan = both_plans(a, block_h=128, block_unroll=2)
    odd = dataclasses.replace(tplan, total_blocks=tplan.total_blocks - 1)
    with pytest.raises(ValueError, match="multiple of block_unroll"):
        spmm_subtile(odd, torch.zeros(600, 8))

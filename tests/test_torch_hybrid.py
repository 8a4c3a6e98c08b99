"""Parity of the port's hybrid plans and SpMM with the JAX package on the
CPU.

`csr_preprocess_hybrid` splits the edges with the JAX package's numpy
passes, so both sides' plans are compared bit for bit. The SpMM runs the
sides' plain versions (K3's and K1's, or K2's) on a CPU tensor; the JAX
side runs `spmm_pallas_hybrid` in interpret mode. Outputs and gradients
agree to rtol 1e-5, atol 1e-4 (tests/test_spmm.py:51-52: float32 sums in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu_torch.ops import (
    spmm_block,
    spmm_fused_reference,
    spmm_reference,
    spmm_subtile_reference,
)

TOL = dict(rtol=1e-5, atol=1e-4)
PLAN_FIELDS = ("hind", "window_of_block", "block_ptr")
PLAN_SCALARS = ("num_nodes", "num_edges", "num_windows", "total_blocks", "has_empty_windows",
                "source_rows")


def community_csr(n, local_frac, seed, deg=8):
    """Edges mostly inside 64-node communities (dense runs) plus a random
    tail (scattered lanes)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, deg * n)
    local = rng.random(rows.shape[0]) < local_frac
    cols = np.where(local, rows // 64 * 64 + rng.integers(0, 64, rows.shape[0]),
                    rng.integers(0, n, rows.shape[0]))
    cols = np.minimum(cols, n - 1)
    a = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(n, n))
    a.data[:] = 1.0
    return a


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# (label, csr, kwargs of csr_preprocess_hybrid, which sides hold blocks)
def hybrid_cases():
    mixed = community_csr(1000, 0.7, seed=1)
    return {
        "defaults": (mixed, {}, (True, True)),
        "all dense": (community_csr(512, 1.0, seed=2, deg=40),
                      dict(dense_config=(64, 128, 8), threshold=2), (True, False)),
        "all sparse": (mixed, dict(threshold=9), (False, True)),
        "empty graph": (sp.csr_matrix((300, 300), dtype=np.float32), {}, (False, False)),
        "sparse config given": (mixed, dict(dense_config=(64, 128, 16),
                                            sparse_config=(128, 128, 1, 2)), (True, True)),
        "clustered": (community_csr(1200, 0.7, seed=3),
                      dict(dense_config=(128, 128, 8, 1, True)), (True, True)),
    }


def both_hybrid(label):
    a, kw, sides = hybrid_cases()[label]
    a = sp.csr_matrix(a)
    n = a.shape[0]
    jkw, tkw = dict(kw), dict(kw)
    for key in ("dense_config", "sparse_config"):
        if key in kw:
            jkw[key], tkw[key] = jfmt.PlanConfig(*kw[key]), vt.PlanConfig(*kw[key])
    jplan = jfmt.csr_preprocess_hybrid(a.indptr, a.indices, n, backend="numpy", **jkw)
    tplan = vt.csr_preprocess_hybrid(a.indptr, a.indices, n, **tkw)
    return a, jplan, tplan, sides


def assert_plans_equal(tplan, jplan):
    np.testing.assert_array_equal(tplan.bitmask.numpy().view(np.uint32),
                                  np.asarray(jplan.bitmask))
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)), err_msg=name)
    for name in PLAN_SCALARS:
        assert getattr(tplan, name) == getattr(jplan, name), name
    assert (tplan.occ is None) == (jplan.occ is None)
    if tplan.occ is not None:
        np.testing.assert_array_equal(tplan.occ.numpy().view(np.uint32),
                                      np.asarray(jplan.occ).view(np.uint32))
    for f in dataclasses.fields(tplan.config):
        assert getattr(tplan.config, f.name) == getattr(jplan.config, f.name), f.name


@pytest.mark.parametrize("label", list(hybrid_cases()))
def test_hybrid_plans_match_jax(label):
    _, jplan, tplan, (dense, sparse) = both_hybrid(label)
    assert (tplan.dense.total_blocks > 0, tplan.sparse.total_blocks > 0) == (dense, sparse)
    assert (tplan.num_nodes, tplan.num_edges) == (jplan.num_nodes, jplan.num_edges)
    assert_plans_equal(tplan.dense, jplan.dense)
    assert_plans_equal(tplan.sparse, jplan.sparse)
    assert vt.hybrid_stats(tplan) == jfmt.hybrid_stats(jplan)


@pytest.mark.parametrize("label,dense_impl", [
    ("defaults", "fused"), ("defaults", "pregather"), ("all dense", "fused"),
    ("all sparse", "fused"), ("sparse config given", "fused"), ("clustered", "pregather"),
])
def test_spmm_hybrid_matches_jax(label, dense_impl):
    a, jplan, tplan, _ = both_hybrid(label)
    n = a.shape[0]
    x = features(n, 40, seed=4)
    subtile = tplan.dense.config.cluster_cols
    ref = np.asarray(jops.spmm_pallas_hybrid(jplan, jnp.asarray(x), dense_impl=dense_impl,
                                             subtile=subtile))
    out = vt.spmm_hybrid(tplan, torch.from_numpy(x), dense_impl=dense_impl, subtile=subtile)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), a @ x.astype(np.float64), **TOL)
    if dense_impl == "fused":
        # ops.spmm on a HybridPlan: spmm_hybrid, subtile from the dense side
        ref = np.asarray(jops.spmm(jplan, jnp.asarray(x)))
        np.testing.assert_allclose(vt.spmm(tplan, torch.from_numpy(x)).numpy(), ref, **TOL)


def test_spmm_hybrid_runs_each_side_once():
    """Each side runs its kernel's plain version once on the CPU: K3's on the
    dense side, K1's (K2's with subtile) on the sparse side; a side without
    blocks runs nothing, and two empty sides give zeros."""
    _, _, tplan, _ = both_hybrid("defaults")
    x = torch.from_numpy(features(tplan.num_nodes, 8, seed=5))
    counters = (spmm_fused_reference, spmm_reference, spmm_subtile_reference)
    before = [c.calls for c in counters]
    out = vt.spmm(tplan, x)
    assert [c.calls - b for c, b in zip(counters, before)] == [1, 1, 0]
    before = [c.calls for c in counters]
    assert torch.equal(vt.spmm_hybrid(tplan, x, subtile=True), out)
    assert [c.calls - b for c, b in zip(counters, before)] == [1, 0, 1]
    _, _, dense_only, _ = both_hybrid("all dense")
    before = [c.calls for c in counters]
    vt.spmm(dense_only, torch.from_numpy(features(dense_only.num_nodes, 8, seed=6)))
    assert [c.calls - b for c, b in zip(counters, before)] == [1, 0, 0]
    _, _, empty, _ = both_hybrid("empty graph")
    before = [c.calls for c in counters]
    out = vt.spmm(empty, torch.ones(300, 8), out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (300, 8) and not out.any()
    assert [c.calls for c in counters] == before


def test_spmm_hybrid_dispatch_and_refusals():
    _, jplan, tplan, _ = both_hybrid("defaults")
    n = tplan.num_nodes
    x = torch.from_numpy(features(n, 16, seed=7))
    ref = vt.spmm(tplan, x, impl="reference")
    np.testing.assert_allclose(vt.spmm(tplan, x).numpy(), ref.numpy(), **TOL)
    xb = torch.from_numpy(np.stack([features(n, 4, seed=8), features(n, 4, seed=9)]))
    outb = vt.spmm(tplan, xb)
    assert tuple(outb.shape) == (2, n, 4)
    np.testing.assert_allclose(outb[1].numpy(), vt.spmm(tplan, xb[1].contiguous()).numpy(),
                               **TOL)
    for impl in ("fused", "pregather", "int8"):
        with pytest.raises(ValueError, match="HybridPlan runs"):
            vt.spmm(tplan, x, impl=impl)
    with pytest.raises(ValueError, match="dense_impl"):
        vt.spmm_hybrid(tplan, x, dense_impl="ell")
    with pytest.raises(NotImplementedError, match="not a plan of the port"):
        vt.spmm(jplan, x)
    with pytest.raises(NotImplementedError, match="not a plan of the port"):
        vt.spmm(dataclasses.replace(tplan, sparse=jplan.sparse), x)
    with pytest.raises(ValueError, match="gather_segment"):
        vt.csr_preprocess_hybrid(np.zeros(11, np.int64), np.zeros(0, np.int64), 10,
                                 dense_config=vt.PlanConfig(128, 128, 1))


@pytest.mark.parametrize("label", ["defaults", "clustered"])
def test_spmm_ad_on_hybrid_plans_matches_jax_grad(label):
    """spmm_ad over a HybridPlan of A and one of A^T: the output and the
    gradient as jax.grad has them."""
    a = sp.csr_matrix(hybrid_cases()[label][0])
    n = a.shape[0]
    at = a.T.tocsr()
    assert (a != at).nnz  # asymmetric: the backward needs A^T's plan
    kw = hybrid_cases()[label][1]
    cfg_j = {k: jfmt.PlanConfig(*v) for k, v in kw.items()}
    cfg_t = {k: vt.PlanConfig(*v) for k, v in kw.items()}
    jp, jpt = (jfmt.csr_preprocess_hybrid(m.indptr, m.indices, n, backend="numpy", **cfg_j)
               for m in (a, at))
    tp, tpt = (vt.csr_preprocess_hybrid(m.indptr, m.indices, n, **cfg_t) for m in (a, at))
    x, w = features(n, 24, seed=10), features(n, 24, seed=11)

    def jloss(xj):
        return jnp.sum(jops.spmm_ad(jp, jpt, xj) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vt.spmm_ad(tp, tpt, xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), a @ x.astype(np.float64), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    xr = torch.from_numpy(x).requires_grad_(True)
    (vt.spmm_ad(tp, tpt, xr, impl="reference") * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), xt.grad.numpy(), **TOL)


def test_spmm_ad_refuses_value_planes_inside_a_hybrid_plan():
    _, _, tplan, _ = both_hybrid("defaults")
    s = tplan.sparse
    cfg = s.config
    weighted = dataclasses.replace(
        tplan, sparse=dataclasses.replace(
            s, values=torch.ones(s.total_blocks, cfg.block_h, cfg.block_w)))
    x = torch.zeros(tplan.num_nodes, 4)
    for args in ((weighted, tplan), (tplan, weighted)):
        with pytest.raises(ValueError, match="value plane"):
            vt.spmm_ad(*args, x)


def test_hybrid_plan_moves_both_sides():
    _, _, tplan, _ = both_hybrid("defaults")
    moved = tplan.to("meta")
    for side in (moved.dense, moved.sparse):
        for name in ("bitmask", "hind", "window_of_block", "block_ptr"):
            assert getattr(side, name).device.type == "meta", name
    assert (moved.num_nodes, moved.num_edges) == (tplan.num_nodes, tplan.num_edges)
    assert tplan.dense.bitmask.device.type == "cpu"
    assert spmm_block.launches == 0  # nothing above launched a kernel

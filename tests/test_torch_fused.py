"""Parity of the PyTorch port's coverage-fused SpMM (kernel K3's plain
version), its dispatch, the bounded-memory plain versions, mixed plans
under spmm_ad, and the GCN slice on the two new plan configs, with the
JAX package on the CPU.

On a CPU tensor the port runs each kernel's plain version; the JAX side
runs `spmm_pallas_fused` / `spmm_pallas` in interpret mode and
`build_graph(backend="numpy")`, as its own tests do. SpMM outputs are
compared at tests/test_spmm.py:51-52 tolerance, logits and gradients at
rtol 1e-4, atol 1e-4 (two aggregations and two dense products in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu as jvx
import voltrix_spmm_tpu.format.preprocess as jpre
import voltrix_spmm_tpu.models as jmodels
from voltrix_spmm_tpu.models.graph import auto_plan_config
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.format import coverage_expansion
from voltrix_spmm_tpu_torch.ops import (
    spmm_fused, spmm_fused_reference, spmm_reference, spmm_scipy, spmm_subtile_reference,
)

TOL = dict(rtol=1e-5, atol=1e-4)
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)


def random_csr(n, density, seed, num_cols=None):
    a = sp.random(n, num_cols or n, density=density, format="csr",
                  random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a


def drop_rows(a, keep):
    mask = np.array([keep(r) for r in range(a.shape[0])], dtype=np.float32)
    return (sp.diags(mask) @ a).tocsr()


def both_plans(a, **cfg):
    n = a.shape[0]
    jplan = jvx.csr_preprocess(a.indptr, a.indices, n, jvx.PlanConfig(**cfg), backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg))
    return jplan, tplan


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def assert_close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert vt.calc_diff(out, ref) < 1e-6
    np.testing.assert_allclose(out, ref, **tol)


# tests/test_spmm.py:88-90, then the K3 geometries chip_smoke.py checks
FUSED_CASES = [
    (512, 0.05, 64, dict(block_h=128, block_w=128, gather_segment=8)),
    (300, 0.02, 130, dict(block_h=32, block_w=128, gather_segment=16)),
    (700, 0.01, 256, dict(block_h=64, block_w=256, gather_segment=32)),
    (3000, 0.01, 8, dict(block_h=2048, gather_segment=128, block_unroll=4)),  # tail past n
    (1500, 0.02, 300, dict(block_h=256, gather_segment=64, block_unroll=2)),
]


@pytest.mark.parametrize("n,density,d,cfg", FUSED_CASES)
def test_fused_spmm_matches_jax(n, density, d, cfg):
    a = random_csr(n, density, seed=n + d)
    jplan, tplan = both_plans(a, **cfg)
    if cfg["gather_segment"] == 128:
        assert int(tplan.hind.max()) >= n  # the last run reaches past the last row
    x = features(n, d, seed=1)
    ref = np.asarray(jops.spmm_pallas_fused(jplan, jnp.asarray(x)))
    calls = spmm_fused_reference.calls
    out = vt.spmm(tplan, torch.from_numpy(x))  # "auto" -> fused for seg >= 8
    assert spmm_fused_reference.calls == calls + 1
    assert_close(out, ref)
    assert_close(out, spmm_scipy(a.indptr, a.indices, n, x))
    assert torch.equal(vt.spmm(tplan, torch.from_numpy(x), impl="fused"), out)


@pytest.mark.parametrize("case", ["padded", "left_empty", "empty_matrix"])
def test_fused_spmm_empty_windows_match_jax(case):
    n, d = 4096, 40
    if case == "padded":
        a, cfg = drop_rows(random_csr(2048, 0.01, 2), lambda r: not 256 <= r < 512), \
            dict(block_h=128, gather_segment=8)
        n = 2048
    elif case == "left_empty":
        a, cfg = drop_rows(random_csr(n, 0.01, 3), lambda r: r < 32), \
            dict(block_h=32, gather_segment=8, block_unroll=2)
    else:
        a, cfg = random_csr(n, 0.0, 4), dict(block_h=128, gather_segment=8)
    jplan, tplan = both_plans(a, **cfg)
    assert tplan.has_empty_windows == (case != "padded")
    x = features(n, d, seed=2)
    out = vt.spmm(tplan, torch.from_numpy(x))
    assert_close(out, np.asarray(jvx.spmm(jplan, jnp.asarray(x))))
    assert_close(out, spmm_scipy(a.indptr, a.indices, n, x))


@pytest.mark.parametrize("seg,impl,plain", [
    (16, "auto", "fused"),      # JAX test_spmm_auto_impl_uses_fused
    (8, "auto", "fused"),
    (4, "auto", "block"),       # seg < 8: the pregather path, K1
    (8, "pregather", "block"),  # explicit impl overrides the plan
    (8, "reference", "block"),
])
def test_spmm_dispatch_matches_jax(seg, impl, plain):
    n, d = 256, 64
    a = random_csr(n, 0.05, seed=5)
    jplan, tplan = both_plans(a, block_h=32, gather_segment=seg)
    x = features(n, d, seed=3)
    counters = {"fused": spmm_fused_reference, "block": spmm_reference}
    before = {k: f.calls for k, f in counters.items()}
    out = vt.spmm(tplan, torch.from_numpy(x), impl=impl)
    after = {k: f.calls for k, f in counters.items()}
    assert {k: after[k] - before[k] for k in counters} == {k: int(k == plain) for k in counters}
    jimpl = "pallas" if impl == "pregather" else impl
    assert_close(out, np.asarray(jvx.spmm(jplan, jnp.asarray(x), impl=jimpl)))


def test_fused_refuses_plans_it_does_not_take():
    a = random_csr(256, 0.05, seed=6)
    _, seg4 = both_plans(a, block_h=32, gather_segment=4)
    with pytest.raises(ValueError, match="gather_segment >= 8"):
        vt.spmm(seg4, torch.zeros(256, 8), impl="fused")
    _, h48 = both_plans(a, block_h=48, gather_segment=8)
    with pytest.raises(ValueError, match="block_h % 32"):
        spmm_fused(h48, torch.zeros(256, 8))


@pytest.mark.parametrize("kwargs", [
    dict(block_d=128), dict(slots=3), dict(precision="highest"),
    dict(compute_dtype=torch.bfloat16),
])
def test_spmm_refuses_tpu_tiling_knobs(kwargs):
    """The TPU tiling knobs stay refused; compute_dtype=bfloat16, refused
    until the kernels read bf16 rows, now runs K3's bf16 source and matches
    JAX's compute_dtype (a float32 result at the float32 tolerance)."""
    jplan, tplan = both_plans(random_csr(256, 0.05, seed=7), block_h=32, gather_segment=8)
    if "compute_dtype" in kwargs:
        x = features(256, 8, seed=7)
        out = vt.spmm(tplan, torch.from_numpy(x), **kwargs)
        assert out.dtype == torch.float32
        assert_close(out, np.asarray(jvx.spmm(jplan, jnp.asarray(x), compute_dtype=jnp.bfloat16)))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
        vt.spmm(tplan, torch.zeros(256, 8), **kwargs)
    vt.spmm(tplan, torch.zeros(256, 8), compute_dtype=torch.float32)  # the kernels' own


@pytest.mark.parametrize("plain,cfg", [
    (spmm_reference, dict(block_h=128, block_w=128)),
    (spmm_subtile_reference, dict(block_h=256, block_unroll=2, cluster_cols=True)),
    (spmm_fused_reference, dict(block_h=256, gather_segment=32, block_unroll=2)),
])
def test_plain_versions_chunked_equal_one_shot(plain, cfg):
    """The plain versions walk the blocks in chunks of bounded bytes;
    chunks of three blocks and one chunk of all blocks give the same sums."""
    n, d = 1000, 48
    _, tplan = both_plans(random_csr(n, 0.01, seed=8), **cfg)
    x = torch.from_numpy(features(n, d, seed=4))
    h, k = tplan.config.block_h, tplan.config.block_w
    three_blocks = 3 * 4 * (h * k + k * d + h * d)
    assert tplan.total_blocks > 6
    assert torch.equal(plain(tplan, x, chunk_bytes=2**40), plain(tplan, x, chunk_bytes=three_blocks))


@pytest.mark.parametrize("n,seed,block_h,seg", [
    (3000, 0, 2048, 128), (1500, 1, 256, 8), (700, 2, 64, 16),
])
def test_coverage_expansion_matches_jax(n, seed, block_h, seg):
    a = symmetrize(chung_lu_csr(n, 8 * n, seed=seed))
    got = coverage_expansion(a.indptr, a.indices, n, block_h, seg)
    assert got == jpre.coverage_expansion(a.indptr, a.indices, n, block_h, seg)
    assert got > 0
    assert coverage_expansion(np.zeros(n + 1, np.int64), np.zeros(0, np.int64), n, block_h, seg) == 0.0


def test_spmm_ad_mixed_plans_matches_jax():
    """A clustered plan for A and a fused plan for A^T on an asymmetric
    graph: each side dispatches on its own plan (K2 forward, K3 backward),
    and forward and gradient match jax.grad."""
    n, d = 1200, 40
    a = random_csr(n, 0.01, seed=9)
    assert (a != a.T).nnz
    at = a.T.tocsr()
    jplan, tplan = both_plans(a, block_h=256, block_unroll=2, cluster_cols=True)
    jplan_t, tplan_t = both_plans(at, block_h=256, gather_segment=16, block_unroll=2)
    x = features(n, d, seed=5)
    w = features(n, d, seed=6)

    def jloss(xj):
        return jnp.sum(jops.spmm_ad(jplan, jplan_t, xj) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    sub, fused, block = (spmm_subtile_reference.calls, spmm_fused_reference.calls,
                         spmm_reference.calls)
    out = vt.spmm_ad(tplan, tplan_t, xt)
    (out * torch.from_numpy(w)).sum().backward()
    assert (spmm_subtile_reference.calls - sub, spmm_fused_reference.calls - fused,
            spmm_reference.calls - block) == (1, 1, 0)
    assert_close(out.detach(), np.asarray(jops.spmm_ad(jplan, jplan_t, jnp.asarray(x))))
    assert_close(out.detach(), spmm_scipy(a.indptr, a.indices, n, x))
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), at @ w, **TOL)


def jax_params(in_dim, hidden, classes, seed):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((in_dim, hidden)) * (2.0 / in_dim) ** 0.5).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(hidden)).astype(np.float32),
        "w2": (rng.standard_normal((hidden, classes)) * (2.0 / hidden) ** 0.5).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(classes)).astype(np.float32),
    }


@pytest.mark.parametrize("path", ["clustered", "fused"])
def test_gcn_slice_matches_jax(path):
    """The slice as chip_smoke.py drives paths B and C, at a small size: a
    symmetric graph, the path's PlanConfig, which JAX's auto_plan_config
    also picks for this graph, three requests through the GCN, and the
    path's kernel (plain version here) twice per request."""
    if path == "clustered":
        a = symmetrize(chung_lu_csr(8192, 12000, seed=10))
        cfg = dict(block_h=2048, block_w=128, block_unroll=4, cluster_cols=True)
        widths, counter = (32, 24, 6), spmm_subtile_reference
    else:
        a = symmetrize(random_csr(3000, 0.03, seed=11))
        cfg = dict(block_h=2048, block_w=128, gather_segment=128, block_unroll=4)
        widths, counter = (8, 24, 12), spmm_fused_reference
    n = a.shape[0]
    assert auto_plan_config(a.indptr, a.indices, n) == jvx.PlanConfig(**cfg)
    gj = jmodels.build_graph(a.indptr, a.indices, n, jvx.PlanConfig(**cfg), symmetric=True,
                             backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(**cfg), symmetric=True,
                        device="cpu")
    p = jax_params(*widths, seed=12)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    model = vt.GCN.from_params(vt.gcn_params_from_jax(p, device="cpu")).eval()
    for request in range(3):
        x = features(n, widths[0], seed=20 + request)
        calls, k1 = counter.calls, spmm_reference.calls
        with torch.no_grad():
            out = model(gt, torch.from_numpy(x))
        assert (counter.calls - calls, spmm_reference.calls - k1) == (2, 0)
        assert out.shape == (n, widths[2]) and bool(torch.isfinite(out).all())
        ref = np.asarray(jmodels.gcn_forward(pj, gj, jnp.asarray(x)))
        np.testing.assert_allclose(out.numpy(), ref, **TOL_LOGITS)

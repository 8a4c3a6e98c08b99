"""Parity of the port's window-chunked plans and streamed dispatch with the
JAX package on the CPU.

`slice_plan_windows` and `csr_preprocess_streamed` are compared with the
JAX package's bit for bit. A chunk keeps each of its windows' blocks in
order, so the SpMM over the chunks equals the SpMM over the whole plan
exactly (torch.equal); against the JAX package's interpret-mode kernels
the outputs agree to rtol 1e-5, atol 1e-4 (tests/test_spmm.py:51-52), the
streamed GCN's logits to 1e-5 and its gradients to 1e-4
(tests/test_models.py:422,429).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu.format.stream import csr_preprocess_streamed as jcsr_preprocess_streamed
from voltrix_spmm_tpu.format.stream import slice_plan_windows as jslice_plan_windows
from voltrix_spmm_tpu_torch.format import estimate_gather_bytes
from voltrix_spmm_tpu_torch.ops import (
    spmm_block,
    spmm_fused_reference,
    spmm_reference,
    spmm_subtile_reference,
)

TOL = dict(rtol=1e-5, atol=1e-4)
FIELDS = ("bitmask", "hind", "window_of_block", "block_ptr", "occ", "values")
SCALARS = ("num_nodes", "num_edges", "num_windows", "total_blocks", "has_empty_windows",
           "num_cols", "source_rows")


def random_csr(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a


def head_rows_csr(seed, n=9000, keep=300):
    """Edges in the first `keep` rows only: most windows are left without
    blocks (too many to pad), so later chunks hold none."""
    a = sp.diags((np.arange(n) < keep).astype(np.float32)) @ random_csr(n, 0.002, seed)
    return sp.csr_matrix(a)


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


CONFIGS = {
    "h64 unroll 2": dict(block_h=64, block_unroll=2),
    "clustered h256": dict(block_h=256, block_unroll=2, cluster_cols=True),
    "coverage seg 8": dict(block_h=64, gather_segment=8),
}


def both_plans(a, values=None, **cfg):
    n = a.shape[0]
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, n, jfmt.PlanConfig(block_w=128, **cfg),
                                backend="numpy", values=values)
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(block_w=128, **cfg),
                              values=values)
    return jplan, tplan


def assert_chunks_equal(tsubs, jsubs):
    assert len(tsubs) == len(jsubs)
    for t, j in zip(tsubs, jsubs):
        for name in FIELDS:
            tv, jv = getattr(t, name), getattr(j, name)
            assert (tv is None) == (jv is None), name
            if tv is not None:
                want = np.asarray(jv)
                np.testing.assert_array_equal(tv.numpy().view(want.dtype), want, err_msg=name)
        for name in SCALARS:
            assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("chunks", [1, 3, 7, 64])
def test_slice_plan_windows_matches_jax(chunks):
    a = random_csr(900, 0.03, seed=1)  # unaligned n: the last chunk keeps the row tail
    jplan, tplan = both_plans(a, **CONFIGS["h64 unroll 2"])
    tsubs = vt.slice_plan_windows(tplan, chunks)
    assert_chunks_equal(tsubs, jslice_plan_windows(jplan, chunks))
    assert len(tsubs) <= chunks
    assert sum(s.num_nodes for s in tsubs) == tplan.num_nodes
    assert sum(s.total_blocks for s in tsubs) == tplan.total_blocks
    # the chunks' tensors are slices of the plan's, on its device
    assert tsubs[-1].bitmask.data_ptr() >= tplan.bitmask.data_ptr()
    assert all(s.bitmask.is_contiguous() and s.hind.is_contiguous() for s in tsubs)


@pytest.mark.parametrize("kind", ["clustered h256", "coverage seg 8", "weighted", "empty windows"])
def test_slice_plan_windows_other_plans_match_jax(kind):
    a = random_csr(900, 0.03, seed=2)
    values = None
    cfg = CONFIGS.get(kind, dict(block_h=64))
    if kind == "weighted":
        values = np.random.default_rng(3).standard_normal(a.nnz).astype(np.float32)
    if kind == "empty windows":
        a = head_rows_csr(seed=2)
    jplan, tplan = both_plans(a, values=values, **cfg)
    tsubs = vt.slice_plan_windows(tplan, 5)
    assert_chunks_equal(tsubs, jslice_plan_windows(jplan, 5))
    if kind == "empty windows":
        assert any(s.total_blocks == 0 for s in tsubs)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_csr_preprocess_streamed_matches_jax_and_slices(cfg):
    a = random_csr(900, 0.03, seed=4)
    n = a.shape[0]
    jcfg, tcfg = jfmt.PlanConfig(block_w=128, **CONFIGS[cfg]), vt.PlanConfig(block_w=128,
                                                                             **CONFIGS[cfg])
    got = vt.csr_preprocess_streamed(a.indptr, a.indices, n, tcfg, num_chunks=4, device="cpu")
    assert_chunks_equal(got, jcsr_preprocess_streamed(a.indptr, a.indices, n, jcfg,
                                                      num_chunks=4, backend="numpy",
                                                      to_device=False))
    full = vt.csr_preprocess(a.indptr, a.indices, n, tcfg)
    for s_got, s_want in zip(got, vt.slice_plan_windows(full, 4)):
        for name in ("bitmask", "hind", "window_of_block", "block_ptr"):
            assert torch.equal(getattr(s_got, name), getattr(s_want, name)), name
        assert (s_got.num_nodes, s_got.source_rows) == (s_want.num_nodes, s_want.source_rows)
    x = torch.from_numpy(features(n, 24, seed=5))
    assert torch.equal(vt.spmm(got, x), vt.spmm(full, x, impl="pregather",
                                                 subtile=tcfg.cluster_cols))


@pytest.mark.parametrize("chunks", [1, 3, 7, 64])
def test_spmm_streamed_matches_unstreamed_and_jax(chunks):
    a = random_csr(900, 0.03, seed=6)
    jplan, tplan = both_plans(a, **CONFIGS["h64 unroll 2"])
    x = features(900, 48, seed=7)
    xt = torch.from_numpy(x)
    whole = vt.spmm(tplan, xt)
    out = vt.spmm_streamed(tplan, xt, num_chunks=chunks)
    assert torch.equal(out, whole)
    subs = vt.slice_plan_windows(tplan, chunks)
    assert torch.equal(vt.spmm(subs, xt), whole)
    assert torch.equal(vt.spmm(tuple(subs), xt, impl="reference"), whole)
    assert torch.equal(vt.spmm_streamed((s for s in subs), xt), whole)  # a one-shot generator
    ref = np.asarray(jops.spmm_streamed(jplan, jnp.asarray(x), num_chunks=chunks))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), a @ x.astype(np.float64), **TOL)


def test_spmm_on_chunk_lists_dispatches_as_jax():
    """ops.spmm on a chunk list runs K1 (K2 on clustered chunks, as the JAX
    package picks subtile from the first chunk) on every chunk, coverage
    chunks too; spmm_ad sends coverage chunks to K3. A chunk without blocks
    runs nothing."""
    a = random_csr(900, 0.03, seed=8)
    x = features(900, 16, seed=9)
    xt = torch.from_numpy(x)
    for cfg, counter in (("clustered h256", spmm_subtile_reference),
                         ("coverage seg 8", spmm_reference)):
        jplan, tplan = both_plans(a, **CONFIGS[cfg])
        subs = vt.slice_plan_windows(tplan, 3)
        calls = counter.calls
        out = vt.spmm(subs, xt)
        assert counter.calls == calls + len(subs) and len(subs) > 1
        ref = np.asarray(jops.spmm(jslice_plan_windows(jplan, 3), jnp.asarray(x)))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    calls = spmm_fused_reference.calls
    np.testing.assert_allclose(vt.spmm_ad(subs, subs, xt).numpy(), out.numpy(), **TOL)
    assert spmm_fused_reference.calls == calls + len(subs)
    rows = head_rows_csr(seed=8)
    plan = vt.csr_preprocess(rows.indptr, rows.indices, 9000, vt.PlanConfig(64, 128))
    subs = vt.slice_plan_windows(plan, 3)
    assert [s.total_blocks > 0 for s in subs] == [True, False, False]
    xt = torch.from_numpy(features(9000, 16, seed=9))
    calls = spmm_reference.calls
    out = vt.spmm(subs, xt)
    assert spmm_reference.calls == calls + 1
    assert torch.equal(out, vt.spmm(plan, xt)) and not out[320:].any()


def test_spmm_chunk_lists_refuse_what_jax_refuses():
    a = random_csr(600, 0.03, seed=10)
    values = np.ones(a.nnz, np.float32)
    jplan, tplan = both_plans(a, **CONFIGS["h64 unroll 2"])
    _, weighted = both_plans(a, values=values, block_h=64)
    x = torch.zeros(600, 8)
    subs = vt.slice_plan_windows(tplan, 3)
    for impl in ("fused", "weighted", "int8", "ell"):
        with pytest.raises(ValueError, match="window-chunk plan lists run"):
            vt.spmm(subs, x, impl=impl)
    wsubs = vt.slice_plan_windows(weighted, 3)
    for call in (lambda: vt.spmm(wsubs, x), lambda: vt.spmm(wsubs, x, impl="reference"),
                 lambda: vt.spmm_streamed(weighted, x), lambda: vt.spmm_ad(wsubs, wsubs, x)):
        with pytest.raises(ValueError, match="value plane"):
            call()
    with pytest.raises(NotImplementedError, match="not a plan of the port"):
        vt.spmm(jslice_plan_windows(jplan, 3), x)
    with pytest.raises(NotImplementedError, match="window chunks"):
        vt.spmm([subs[0], [subs[1]]], x)
    with pytest.raises(ValueError, match="empty list"):
        vt.spmm_streamed([], x)
    with pytest.raises(ValueError, match="num_chunks"):
        vt.slice_plan_windows(tplan, 0)


def test_spmm_ad_on_chunks_matches_jax_grad():
    """spmm_ad over chunk lists of A and of A^T (an asymmetric graph, with
    coverage chunks for A^T): output and gradient as jax.grad has them."""
    n, d = 700, 24
    a = random_csr(n, 0.02, seed=11)
    at = a.T.tocsr()
    jp, tp = both_plans(a, block_h=64)
    jpt, tpt = both_plans(at, block_h=64, gather_segment=8)
    jsubs, jsubs_t = jslice_plan_windows(jp, 3), jslice_plan_windows(jpt, 4)
    tsubs, tsubs_t = vt.slice_plan_windows(tp, 3), vt.slice_plan_windows(tpt, 4)
    x, w = features(n, d, seed=12), features(n, d, seed=13)

    def jloss(xj):
        return jnp.sum(jops.spmm_ad(jsubs, jsubs_t, xj) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vt.spmm_ad(tsubs, tsubs_t, xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), a @ x.astype(np.float64), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    xw = torch.from_numpy(x).requires_grad_(True)
    (vt.spmm_ad(tp, tpt, xw) * torch.from_numpy(w)).sum().backward()
    assert torch.equal(xt.grad, xw.grad)  # the unstreamed plans, bit for bit


def jax_params(in_dim, hidden, classes, seed=0):
    p = {k: np.asarray(v) for k, v in
         jmodels.init_gcn(jax.random.PRNGKey(seed), in_dim, hidden, classes).items()}
    rng = np.random.default_rng(seed)
    p["b1"] = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    p["b2"] = (0.1 * rng.standard_normal(classes)).astype(np.float32)
    return p


@pytest.mark.parametrize("symmetric", [True, False])
def test_build_graph_streamed_matches_jax_and_unstreamed(symmetric):
    """build_graph(stream_chunks=3): GCN logits and gcn_loss gradients
    match the JAX package's streamed graph (1e-5 / 1e-4) and equal the
    port's unstreamed graph bit for bit."""
    if symmetric:
        a = symmetrize(chung_lu_csr(1500, 6000, seed=14))
    else:
        a = random_csr(700, 0.02, seed=14)
    n = a.shape[0]
    cfg = dict(block_h=128, block_w=128, block_unroll=2)
    gj = jmodels.build_graph(a.indptr, a.indices, n, jfmt.PlanConfig(**cfg), symmetric=symmetric,
                             backend="numpy", stream_chunks=3)
    gs = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(**cfg), symmetric=symmetric,
                        stream_chunks=3, device="cpu")
    g1 = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(**cfg), symmetric=symmetric,
                        device="cpu")
    assert isinstance(gs.plan, list) and len(gs.plan) == 3 and gs.num_nodes == n
    assert (gs.plan_t is gs.plan) == symmetric
    assert isinstance(gs.plan_t, list) and len(gs.plan_t) == 3
    assert_chunks_equal(gs.plan_t, gj.plan_t)
    p = jax_params(64, 32, 8, seed=15)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    x = features(n, 64, seed=16)
    y = np.random.default_rng(17).integers(0, 8, n)

    ref = np.asarray(jmodels.gcn_forward(pj, gj, jnp.asarray(x)))
    pt = vt.gcn_params_from_jax(p, device="cpu")
    out = vt.gcn_forward(pt, gs, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, vt.gcn_forward(pt, g1, torch.from_numpy(x)))

    jgrad = jax.grad(jmodels.gcn_loss)(pj, gj, jnp.asarray(x), jnp.asarray(y))
    grads = {}
    for g in (gs, g1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
        loss = vt.gcn_loss(leaves, g, torch.from_numpy(x), torch.from_numpy(y))
        grads[id(g)] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k in pt:
        np.testing.assert_allclose(grads[id(gs)][k].numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
        assert torch.equal(grads[id(gs)][k], grads[id(g1)][k]), k


def test_build_graph_streamed_moves_every_chunk_once():
    a = symmetrize(chung_lu_csr(600, 2000, seed=18))
    g = vt.build_graph(a.indptr, a.indices, a.shape[0], vt.PlanConfig(64, 128), symmetric=True,
                       stream_chunks=4, device="meta")
    assert g.plan_t is g.plan and len(g.plan) == 4
    for s in g.plan:
        for name in ("bitmask", "hind", "window_of_block", "block_ptr"):
            assert getattr(s, name).device.type == "meta", name
    one = vt.build_graph(a.indptr, a.indices, a.shape[0], vt.PlanConfig(64, 128),
                         symmetric=True, stream_chunks=1, device="cpu")
    assert isinstance(one.plan, vt.SpmmPlan)  # one chunk is the whole plan, as in JAX
    assert spmm_block.launches == 0


def test_estimate_gather_bytes():
    a = random_csr(900, 0.03, seed=19)
    _, tplan = both_plans(a, block_h=64)
    assert estimate_gather_bytes(tplan, 256) == tplan.gather_rows * 256 * 4
    assert estimate_gather_bytes(10_000, 128, 2) == 10_000 * 128 * 2


def test_chunk_zero_rows_keep_the_output_dtype():
    rows = head_rows_csr(seed=20)
    plan = vt.csr_preprocess(rows.indptr, rows.indices, 9000, vt.PlanConfig(64, 128))
    x = torch.from_numpy(features(9000, 8, seed=21))
    subs = vt.slice_plan_windows(plan, 3)
    assert subs[-1].total_blocks == 0
    out = vt.spmm(subs, x, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, vt.spmm(plan, x).to(torch.bfloat16))

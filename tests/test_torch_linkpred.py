"""Parity of the PyTorch port's link prediction (models/linkpred.py) with
the JAX package on the CPU: the negative pairs and the rng state after
them, the candidate plans and labels bit for bit, the SDDMM scores, the
loss and its gradients, one Adam step, and the AUC.

The port's GCN encoder runs kernel K1's plain version and its scores run
K7's (backward K6's) on CPU tensors; the JAX side runs its Pallas kernels
in interpret mode. Scores, losses, gradients and updated parameters are
held at rtol/atol 1e-4, tests/test_linkpred.py:74's tolerance for the
scores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch.models import sample_negative_edges
from voltrix_spmm_tpu_torch.ops import (
    spmm_ell_dvals_reference,
    spmm_ell_reference,
    spmm_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = (32, 128)


def community_graph(seed, n=240, comm=4, deg=8):
    """tests/test_linkpred.py:24-35's planted-community graph."""
    rng = np.random.default_rng(seed)
    size = n // comm
    src = np.repeat(np.arange(n), deg)
    intra = ((src // size) * size + rng.integers(0, size, size=src.shape[0])) % n
    rand = rng.integers(0, n, size=src.shape[0])
    dst = np.where(rng.random(src.shape[0]) < 0.92, intra, rand)
    a = sp.csr_matrix((np.ones(src.shape[0], np.float32), (src, dst)), shape=(n, n))
    return ((a + a.T) != 0).astype(np.float32).tocsr()


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def jnp_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def gcn_params(in_dim, hidden, emb, seed):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((in_dim, hidden)) * (2 / in_dim) ** 0.5).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(hidden)).astype(np.float32),
        "w2": (rng.standard_normal((hidden, emb)) * (2 / hidden) ** 0.5).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(emb)).astype(np.float32),
    }


@pytest.mark.parametrize("n,density,num_neg,seed", [
    (200, 0.05, 500, 0), (60, 0.5, 1000, 1), (300, 0.0, 40, 2), (50, 0.3, 0, 3),
])
def test_negative_edges_match_jax(n, density, num_neg, seed):
    """The same pairs, and the rng left in the same state, as the JAX
    package's one-pair-at-a-time rejection loop (a dense graph rejects
    half its draws)."""
    a = sp.random(n, n, density=density, format="csr", random_state=np.random.default_rng(seed))
    rj, rt = np.random.default_rng(10 + seed), np.random.default_rng(10 + seed)
    uj, vj = jmodels.sample_negative_edges(a.indptr, a.indices, n, num_neg, rj)
    ut, vt_ = sample_negative_edges(a.indptr, a.indices, n, num_neg, rt)
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(vt_, vj)
    assert ut.dtype == uj.dtype == np.int64
    assert rt.bit_generator.state == rj.bit_generator.state
    assert len(ut) == num_neg and np.all(ut != vt_) and not a.toarray()[ut, vt_].any()


def test_negative_edges_refuse_too_many():
    a = sp.csr_matrix(np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="exist"):
        sample_negative_edges(a.indptr, a.indices, 4, 1, np.random.default_rng(0))


@pytest.mark.parametrize("neg_ratio", [0.0, 0.5, 1.0])
def test_link_candidates_match_jax(neg_ratio):
    a = community_graph(seed=4)
    n = a.shape[0]
    jp, jpt, jl = jmodels.build_link_candidates(a.indptr, a.indices, n, np.random.default_rng(5),
                                                neg_ratio=neg_ratio, config=JaxPlanConfig(*CFG))
    tp, tpt, tl = vt.build_link_candidates(a.indptr, a.indices, n, np.random.default_rng(5),
                                           neg_ratio=neg_ratio, config=vt.PlanConfig(*CFG),
                                           device="cpu")
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl.sum()) == a.nnz and tl.shape[0] == a.nnz + round(neg_ratio * a.nnz)
    for t, j in ((tp, jp), (tpt, jpt)):
        for name in ("hind", "erow", "vals", "window_of_block", "block_ptr", "edge_lane",
                     "lane_edge"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)
        assert t.num_edges == j.num_edges and t.total_blocks == j.total_blocks


@functools.cache
def problem():
    """The graph, its GCN, the candidates (neg_ratio 1), features, and the
    JAX package's loss and gradients on them (shared by three tests)."""
    a = community_graph(seed=6)
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(*CFG), symmetric=True,
                             backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(*CFG), symmetric=True, device="cpu")
    jp, jpt, jl = jmodels.build_link_candidates(a.indptr, a.indices, n, np.random.default_rng(7),
                                                config=JaxPlanConfig(*CFG))
    tp, tpt, tl = vt.build_link_candidates(a.indptr, a.indices, n, np.random.default_rng(7),
                                           config=vt.PlanConfig(*CFG), device="cpu")
    p = gcn_params(16, 32, 16, seed=8)
    x = features(n, 16, seed=9)
    loss_j, grads_j = jax.value_and_grad(jmodels.link_pred_loss)(jnp_params(p), gj, jp, jpt,
                                                                 jnp.asarray(x), jl)
    return dict(a=a, gj=gj, gt=gt, jp=jp, jpt=jpt, jl=jl, tp=tp, tpt=tpt, tl=tl, p=p, x=x,
                loss_j=float(loss_j), grads_j={k: np.asarray(v) for k, v in grads_j.items()})


def test_link_scores_match_jax():
    pb = problem()
    h = features(pb["a"].shape[0], 16, seed=10)
    ref = np.asarray(jmodels.link_scores(pb["jp"], pb["jpt"], jnp.asarray(h)))
    before = spmm_ell_dvals_reference.calls
    out = vt.link_scores(pb["tp"], pb["tpt"], torch.from_numpy(h))
    assert spmm_ell_dvals_reference.calls == before + 1  # one K7
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the scores are the Gram matrix at the candidate edges, in the plan's CSR order
    le = pb["tp"].lane_edge.numpy()
    lanes = np.nonzero(le >= 0)[0]
    k = pb["tp"].config.block_w
    rows = pb["tp"].window_of_block.numpy()[lanes // k] * pb["tp"].config.block_h + \
        pb["tp"].erow.numpy().reshape(-1)[lanes]
    cols = pb["tp"].hind.numpy().reshape(-1)[lanes]
    want = np.empty(pb["tp"].num_edges)
    want[le[lanes]] = np.sum(h[rows] * h[cols], axis=1)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


def test_link_pred_loss_gradients_match_jax():
    pb = problem()
    params = {k: v.requires_grad_(True) for k, v in vt.gcn_params_from_jax(pb["p"], "cpu").items()}
    calls = spmm_reference.calls, spmm_ell_reference.calls, spmm_ell_dvals_reference.calls
    loss = vt.link_pred_loss(params, pb["gt"], pb["tp"], pb["tpt"], torch.from_numpy(pb["x"]),
                             pb["tl"])
    loss.backward()
    # K1: 2 forward, 1 backward (x needs no gradient); K7 1 (scores); K6 2 (its backward)
    assert (spmm_reference.calls - calls[0], spmm_ell_reference.calls - calls[1],
            spmm_ell_dvals_reference.calls - calls[2]) == (3, 2, 1)
    np.testing.assert_allclose(loss.item(), pb["loss_j"], rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.grad.numpy(), pb["grads_j"][k], **TOL, err_msg=k)


def test_link_pred_adam_step_matches_optax():
    """One make_link_pred_step(Adam) step against the JAX package's
    make_link_pred_step(optax.adam): the loss and the updated parameters."""
    pb = problem()
    tx = optax.adam(5e-3)
    pj = jnp_params(pb["p"])
    updates, _ = tx.update(jnp_params(pb["grads_j"]), tx.init(pj), pj)
    pj_new = optax.apply_updates(pj, updates)
    model = vt.GCN.from_params(vt.gcn_params_from_jax(pb["p"], device="cpu"))
    step = vt.make_link_pred_step(torch.optim.Adam(model.parameters(), lr=5e-3))
    loss = step(model.params(), pb["gt"], pb["tp"], pb["tpt"], torch.from_numpy(pb["x"]), pb["tl"])
    np.testing.assert_allclose(loss.item(), pb["loss_j"], rtol=1e-5)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(pj_new[k]), **TOL, err_msg=k)


def test_link_pred_trains_and_auc_matches_jax():
    pb = problem()
    model = vt.init_link_predictor(16, 32, 16, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    assert isinstance(model, vt.GCN) and tuple(model.w2.shape) == (32, 16)
    step = vt.make_link_pred_step(torch.optim.Adam(model.parameters(), lr=1e-2))
    x = torch.from_numpy(pb["x"])
    losses = [step(model.params(), pb["gt"], pb["tp"], pb["tpt"], x, pb["tl"]).item()
              for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with torch.no_grad():
        scores = vt.link_scores(pb["tp"], pb["tpt"], model(pb["gt"], x))
    auc = vt.link_auc(scores, pb["tl"])
    assert auc == jmodels.link_auc(scores.numpy(), pb["tl"].numpy())
    assert 0.0 <= auc <= 1.0


def test_link_auc_matches_jax():
    rng = np.random.default_rng(11)
    scores = np.round(rng.standard_normal(500), 1)  # ties
    labels = (rng.random(500) < 0.4).astype(np.float32)
    assert vt.link_auc(scores, labels) == jmodels.link_auc(scores, labels)
    assert vt.link_auc(torch.from_numpy(scores), torch.from_numpy(labels)) == \
        jmodels.link_auc(scores, labels)
    s = np.asarray([0.9, 0.8, 0.1, 0.2])
    y = np.asarray([1.0, 1.0, 0.0, 0.0])
    assert vt.link_auc(s, y) == 1.0 and vt.link_auc(-s, y) == 0.0
    assert np.isnan(vt.link_auc(s, np.ones(4)))


def test_linkpred_slice_matches_jax():
    """Path F of chip_smoke.py at a small size: a dense symmetric graph
    (ogbl-ddi's kind), a GCN 32 -> 32 -> 32, the candidates at neg_ratio 1;
    three scoring requests (K1 twice and K7 once each), then one Adam step
    (K1 3, K7 1, K6 2) whose loss matches JAX."""
    a = symmetrize(sp.random(300, 300, density=0.06, format="csr",
                             random_state=np.random.default_rng(12)))
    a.data[:] = 1.0
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(128, 128), symmetric=True,
                             backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(128, 128), symmetric=True,
                        device="cpu")
    jp, jpt, jl = jmodels.build_link_candidates(a.indptr, a.indices, n, np.random.default_rng(13))
    tp, tpt, tl = vt.build_link_candidates(a.indptr, a.indices, n, np.random.default_rng(13),
                                           device="cpu")
    p = gcn_params(32, 32, 32, seed=14)
    model = vt.GCN.from_params(vt.gcn_params_from_jax(p, device="cpu"))
    for request in range(3):
        x = features(n, 32, seed=15 + request)
        calls = spmm_reference.calls, spmm_ell_dvals_reference.calls
        with torch.no_grad():
            scores = vt.link_scores(tp, tpt, model(gt, torch.from_numpy(x)))
        assert (spmm_reference.calls - calls[0], spmm_ell_dvals_reference.calls - calls[1]) == (2, 1)
        if request == 0:
            ref = jmodels.link_scores(jp, jpt, jmodels.gcn_forward(jnp_params(p), gj, jnp.asarray(x)))
            np.testing.assert_allclose(scores.numpy(), np.asarray(ref), **TOL)
    loss_j = jmodels.link_pred_loss(jnp_params(p), gj, jp, jpt, jnp.asarray(x), jl)
    step = vt.make_link_pred_step(torch.optim.Adam(model.parameters(), lr=5e-3))
    calls = spmm_reference.calls, spmm_ell_reference.calls, spmm_ell_dvals_reference.calls
    loss = step(model.params(), gt, tp, tpt, torch.from_numpy(x), tl)
    assert (spmm_reference.calls - calls[0], spmm_ell_reference.calls - calls[1],
            spmm_ell_dvals_reference.calls - calls[2]) == (3, 2, 1)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)

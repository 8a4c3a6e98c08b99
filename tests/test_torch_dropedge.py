"""Parity of the PyTorch port's DropEdge with the JAX package on the CPU.

Plans and edge -> slot maps bit for bit. JAX draws its keep mask inside
`dropedge_aggregate` with jax.random.bernoulli, which no torch generator
reproduces, so the training call is compared on the port's mask: JAX's
value planes are built from that mask as `dropedge.py:101-108` builds
them and go through JAX's `spmm_weighted_ad` in interpret mode; outputs
and the feature gradient at rtol 1e-4, atol 1e-4 (tests/test_torch_gcn.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.ops.weighted import spmm_weighted_ad as jax_spmm_weighted_ad
from voltrix_spmm_tpu_torch.models import dropedge_weights

from test_torch_format import assert_same_plan

TOL = dict(rtol=1e-4, atol=1e-4)
N, D = 300, 16


def random_graph(seed=0):
    a = sp.random(N, N, density=0.04, format="csr", random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a.indptr.astype(np.int64), a.indices.astype(np.int64), a


def duplicate_graph():
    """A CSR whose rows repeat columns: (0, 3) x2, (5, 9) x3, plus random
    edges, rows sorted."""
    _, _, a = random_graph(seed=1)
    coo = a.tocoo()
    rows = np.concatenate([coo.row, [0, 0, 5, 5, 5]])
    cols = np.concatenate([coo.col, [3, 3, 9, 9, 9]])
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=N))]).astype(np.int64)
    return indptr, cols[order].astype(np.int64), None


def both(graph, cfg=(32, 128)):
    indptr, indices, _ = graph
    gj = jmodels.build_dropedge_graph(indptr, indices, N, JaxPlanConfig(*cfg), backend="numpy")
    gt = vt.build_dropedge_graph(indptr, indices, N, vt.PlanConfig(*cfg), device="cpu")
    return gj, gt


def features(seed=2):
    return np.random.default_rng(seed).standard_normal((N, D)).astype(np.float32)


@pytest.mark.parametrize("graph,cfg", [("random", (32, 128)), ("random", (64, 128)),
                                       ("duplicates", (32, 128))])
def test_dropedge_graph_matches_jax(graph, cfg):
    g = random_graph() if graph == "random" else duplicate_graph()
    gj, gt = both(g, cfg)
    assert_same_plan(gj.plan, gt.plan)
    assert_same_plan(gj.plan_t, gt.plan_t)
    np.testing.assert_array_equal(gt.slots.numpy(), np.asarray(gj.slots))
    np.testing.assert_array_equal(gt.slots_t.numpy(), np.asarray(gj.slots_t))
    assert (gt.num_edges, gt.has_duplicate_edges) == (gj.num_edges, gj.has_duplicate_edges)
    assert gt.has_duplicate_edges == (graph == "duplicates")


def test_build_dropedge_graph_default_config_and_refusal():
    indptr, indices, _ = random_graph()
    g = vt.build_dropedge_graph(indptr, indices, N, device="cpu")
    assert g.plan.config == vt.PlanConfig(64, 128)
    with pytest.raises(ValueError):
        vt.build_dropedge_graph(indptr, indices, N, vt.PlanConfig(128, 128, gather_segment=4),
                                device="cpu")


@pytest.mark.parametrize("graph", ["random", "duplicates"])
def test_dropedge_eval_matches_jax(graph):
    """Eval: the binary SpMM without duplicate edges (no plain weighted
    call), the weighted path counting each duplicate with its multiplicity."""
    from voltrix_spmm_tpu_torch.ops import spmm_reference, spmm_weighted_reference

    g = random_graph() if graph == "random" else duplicate_graph()
    gj, gt = both(g)
    x = features()
    want = jmodels.dropedge_aggregate(gj, jnp.asarray(x), jax.random.PRNGKey(0),
                                      deterministic=True)
    spmm_reference.calls = spmm_weighted_reference.calls = 0
    got = vt.dropedge_aggregate(gt, torch.from_numpy(x), deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fast = graph == "random"
    assert (spmm_reference.calls, spmm_weighted_reference.calls) == (int(fast), int(not fast))
    # keep_prob 1.0 is eval too
    assert torch.equal(vt.dropedge_aggregate(gt, torch.from_numpy(x), keep_prob=1.0), got)
    if graph == "duplicates":  # (0, 3) counts twice, (5, 9) three times
        x1 = np.zeros((N, D), np.float32)
        x1[3, 0] = x1[9, 1] = 1.0
        out = vt.dropedge_aggregate(gt, torch.from_numpy(x1), deterministic=True)
        assert out[0, 0].item() == 2.0 and out[5, 1].item() == 3.0


def jax_on_mask(gj, w, x):
    """JAX's training-call arithmetic (dropedge.py:101-115) on given per-edge
    weights, so both packages use one mask."""
    def plane(plan, slots):
        cfg = plan.config
        size = plan.total_blocks * cfg.block_h * cfg.block_w
        return (jnp.zeros(size, jnp.float32).at[slots].add(w)
                .reshape(plan.total_blocks, cfg.block_h, cfg.block_w))

    return jax_spmm_weighted_ad(dataclasses.replace(gj.plan, values=plane(gj.plan, gj.slots)),
                                dataclasses.replace(gj.plan_t, values=plane(gj.plan_t,
                                                                            gj.slots_t)), x)


@pytest.mark.parametrize("graph,keep_prob", [("random", 0.8), ("random", 0.5),
                                             ("duplicates", 0.7)])
def test_dropedge_training_call_matches_jax_on_one_mask(graph, keep_prob):
    g = random_graph() if graph == "random" else duplicate_graph()
    gj, gt = both(g)
    x = features(seed=3)
    wt = dropedge_weights(gt.num_edges, keep_prob, torch.Generator().manual_seed(5))
    kept = wt.count_nonzero().item()
    assert 0 < kept < gt.num_edges
    assert set(torch.unique(wt).tolist()) == {0.0, float(np.float32(1.0) / np.float32(keep_prob))}
    w = jnp.asarray(wt.numpy())
    g_out = np.random.default_rng(4).standard_normal((N, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda xj: jax_on_mask(gj, w, xj), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g_out))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = vt.dropedge_aggregate(gt, xt, torch.Generator().manual_seed(5), keep_prob=keep_prob)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(g_out))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)


def test_dropedge_mask_follows_the_generator():
    _, gt = both(random_graph())
    x = torch.from_numpy(features(seed=6))
    a = vt.dropedge_aggregate(gt, x, torch.Generator().manual_seed(1))
    b = vt.dropedge_aggregate(gt, x, torch.Generator().manual_seed(1))
    c = vt.dropedge_aggregate(gt, x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropedge_expectation():
    """The mean over draws approaches the full aggregation (the JAX
    package's test_dropedge_expectation_and_determinism, on the port)."""
    _, _, a = random_graph()
    _, gt = both(random_graph())
    x = features(seed=7)
    gen = torch.Generator().manual_seed(0)
    acc = sum(vt.dropedge_aggregate(gt, torch.from_numpy(x), gen, keep_prob=0.7)
              for _ in range(48)) / 48
    full = a @ x
    assert np.abs(acc.numpy() - full).mean() < 0.25 * np.abs(full).mean()

"""Parity of the PyTorch port's block-diagonal batching, graph readout and
GIN graph classifier with the JAX package on the CPU.

Batching is numpy in both packages: equal arrays. `graph_readout` sums
and takes maxima in graph order (a stable sort, then segment reduces)
where JAX's segment_sum and segment_max take the ids in any order: equal
at rtol 1e-5, atol 1e-6, on permuted ids too, an empty graph 0 under sum
and mean and -inf under max as in JAX, and the same bits on two calls.
Classifier logits at rtol 1e-4, atol 1e-4 (tests/test_torch_gcn.py),
gradients at rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.data as jdata
import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.data as tdata
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
POOL_TOL = dict(rtol=1e-5, atol=1e-6)


def corpus(count=12, seed=0):
    """examples/train_graph_classify.py's corpus at a small size: dense
    graphs (class 0) and rings (class 1) of 30-80 nodes."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(count):
        n = int(rng.integers(30, 80))
        if i % 2 == 0:
            a = sp.random(n, n, density=0.25, format="csr", random_state=rng)
        else:
            ii = np.arange(n)
            a = sp.csr_matrix((np.ones(n, np.float32), (ii, (ii + 1) % n)), shape=(n, n))
        graphs.append(((a + a.T) != 0).astype(np.float32).tocsr())
        labels.append(i % 2)
    return graphs, np.asarray(labels, np.int64)


def test_block_diagonal_matches_jax():
    graphs, _ = corpus()
    big_j, offs_j = jdata.block_diagonal(graphs)
    big_t, offs_t = tdata.block_diagonal(graphs)
    np.testing.assert_array_equal(offs_t, offs_j)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(big_t, name), getattr(big_j, name))
    assert big_t.shape == big_j.shape


def test_node_graph_ids_and_split_match_jax():
    offs = np.array([0, 3, 3, 7, 12])
    ids = tdata.node_graph_ids(offs)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jdata.node_graph_ids(offs))
    x = np.arange(24).reshape(12, 2)
    for got, want in zip(tdata.split_nodes(x, offs), jdata.split_nodes(x, offs)):
        np.testing.assert_array_equal(got, want)
    parts = tdata.split_nodes(torch.from_numpy(x), offs)
    assert [tuple(p.shape) for p in parts] == [(3, 2), (0, 2), (4, 2), (5, 2)]


def test_block_diagonal_refuses():
    with pytest.raises(ValueError):
        tdata.block_diagonal([])
    with pytest.raises(ValueError):
        tdata.block_diagonal([sp.random(4, 5, density=0.5, format="csr")])


def readout_case(order, seed=1):
    """Node features and graph ids of 5 graphs, graph 3 empty; `order`
    "sorted" (block_diagonal's), or the nodes shuffled."""
    sizes = (13, 1, 40, 0, 27)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((offs[-1], 6)).astype(np.float32)
    ids = tdata.node_graph_ids(offs)
    if order == "permuted":
        perm = rng.permutation(len(ids))
        x, ids = x[perm], ids[perm]
    return x, ids, len(sizes)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("order", ["sorted", "permuted"])
def test_graph_readout_matches_jax(mode, order):
    x, ids, num = readout_case(order)
    want = np.asarray(jmodels.graph_readout(jnp.asarray(x), jnp.asarray(ids), num, mode))
    ids_t = torch.from_numpy(ids.astype(np.int64))
    got = vt.graph_readout(torch.from_numpy(x), ids_t, num, mode)
    np.testing.assert_allclose(got.numpy(), want, **POOL_TOL)
    empty = want[3]
    assert (np.isneginf(empty) if mode == "max" else empty == 0).all()
    assert torch.equal(got, vt.graph_readout(torch.from_numpy(x), ids_t, num, mode))
    # numpy ids give the same
    assert torch.equal(got, vt.graph_readout(torch.from_numpy(x), ids, num, mode))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("order", ["sorted", "permuted"])
def test_graph_readout_gradient_matches_jax(mode, order):
    x, ids, num = readout_case(order, seed=2)
    x[5, 2] = x[7, 2] = 9.0  # a tie at graph 0's max: the gradient is shared
    w = np.random.default_rng(3).standard_normal((num, 6)).astype(np.float32)
    keep = np.isfinite(np.asarray(jmodels.graph_readout(jnp.asarray(x), jnp.asarray(ids), num,
                                                        mode)))

    def loss_j(xj):
        r = jmodels.graph_readout(xj, jnp.asarray(ids), num, mode)
        return jnp.sum(jnp.where(keep, r, 0.0) * w)

    want = jax.grad(loss_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    r = vt.graph_readout(xt, torch.from_numpy(ids.astype(np.int64)), num, mode)
    (torch.where(torch.from_numpy(keep), r, 0.0) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **POOL_TOL)


def test_graph_readout_refuses_unknown_mode():
    with pytest.raises(ValueError):
        vt.graph_readout(torch.zeros(3, 2), np.zeros(3, np.int32), 1, "median")


def classifier_case(seed=0):
    graphs, labels = corpus(seed=seed)
    big, offs = jdata.block_diagonal(graphs)
    ids = jdata.node_graph_ids(offs)
    n = big.shape[0]
    gj = jmodels.build_graph(big.indptr, big.indices, n, JaxPlanConfig(128, 128),
                             symmetric=True, backend="numpy")
    gt = vt.build_graph(big.indptr, big.indices, n, vt.PlanConfig(128, 128), symmetric=True,
                        device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal((n, 8)).astype(np.float32)
    pj = {k: np.asarray(v) for k, v in
          jmodels.init_gin_classifier(jax.random.PRNGKey(seed), 8, 16, 2).items()}
    rng = np.random.default_rng(seed + 2)
    for k in ("eps1", "eps2", "b1a", "b2b", "b_head"):
        pj[k] = (0.1 * rng.standard_normal(pj[k].shape)).astype(np.float32)
    return gj, gt, x, ids, labels, pj


@pytest.mark.parametrize("readout", ["sum", "mean", "max"])
def test_gin_classifier_matches_jax(readout):
    gj, gt, x, ids, labels, pj = classifier_case()
    num = len(labels)

    def loss_j(p):
        logits = jmodels.gin_classifier_forward(p, gj, jnp.asarray(x), jnp.asarray(ids), num,
                                                readout)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

    (want_loss, want), grads = jax.value_and_grad(loss_j, has_aux=True)(pj)
    pt = {k: v.requires_grad_(True)
          for k, v in vt.gin_classifier_params_from_jax(pj, device="cpu").items()}
    ids_t = torch.from_numpy(ids.astype(np.int64))
    got = vt.gin_classifier_forward(pt, gt, torch.from_numpy(x), ids_t, num, readout)
    assert got.shape == (num, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    loss = torch.nn.functional.cross_entropy(got, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    for k, v in pt.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads[k]), **GRAD_TOL, err_msg=k)


def test_gin_classifier_step_matches_optax():
    gj, gt, x, ids, labels, pj = classifier_case(seed=4)
    opt = optax.adam(1e-2)
    new_j, _, loss_j = jmodels.make_classifier_train_step(opt)(
        pj, opt.init(pj), gj, jnp.asarray(x), jnp.asarray(ids), jnp.asarray(labels))
    model = vt.GINClassifier.from_params(vt.gin_classifier_params_from_jax(pj, device="cpu"))
    step = vt.make_classifier_train_step(torch.optim.Adam(model.parameters(), lr=1e-2))
    loss = step(model.params(), gt, torch.from_numpy(x), torch.from_numpy(ids.astype(np.int64)),
                torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(new_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_gin_classifier_module_and_batch_invariance():
    """The batched logits equal each graph's alone (block-diagonal
    adjacency, sum aggregation), and the module draws from its generator."""
    graphs, _ = corpus(count=4, seed=5)
    big, offs = tdata.block_diagonal(graphs)
    model = vt.GINClassifier(8, 16, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    assert tuple(model.params()["w_head"].shape) == (32, 2)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((big.shape[0], 8))
                         .astype(np.float32))
    g = vt.build_graph(big.indptr, big.indices, big.shape[0], symmetric=True, device="cpu")
    with torch.no_grad():
        batched = model(g, x, tdata.node_graph_ids(offs), len(graphs))
        for i, a in enumerate(graphs):
            gi = vt.build_graph(a.indptr, a.indices, a.shape[0], symmetric=True, device="cpu")
            alone = model(gi, x[offs[i]:offs[i + 1]], np.zeros(a.shape[0], np.int32), 1)
            torch.testing.assert_close(batched[i:i + 1], alone, rtol=1e-5, atol=1e-5)

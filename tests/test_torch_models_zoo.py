"""Parity of the PyTorch port's full-graph model families with the JAX
package on the CPU: SAGE, GIN, APPNP, deep GCN (recomputed layers on and
off) and R-GCN (full relation weights and bases).

The same graph, parameters and features give the same logits at rtol
1e-4, atol 1e-4 (tests/test_torch_gcn.py:23) and the same loss gradients
as `jax.grad` at rtol 1e-4, atol 1e-5. The port aggregates through K1's
plain version on CPU tensors, JAX through `spmm_pallas` in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, erdos_renyi_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
N, D_IN, HIDDEN, CLASSES = 500, 24, 16, 5


def graph_pair(a, block_h=128, symmetric=None):
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(block_h, 128),
                             symmetric=symmetric, backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(block_h, 128),
                        symmetric=symmetric, device="cpu")
    return gj, gt


def power_law(seed=0):
    return symmetrize(chung_lu_csr(N, 2500, seed=seed))


def numpy_tree(tree, seed=0):
    """A JAX parameter tree as numpy, each zero array (biases, eps) made
    nonzero so every term is checked."""
    rng = np.random.default_rng(seed)

    def leaf(v):
        v = np.asarray(v)
        return (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if not v.any() else v

    return jax.tree_util.tree_map(leaf, tree)


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, N)
    return x, y


def ce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def requires_grad(tree):
    return jax.tree_util.tree_map(lambda t: t.requires_grad_(True), tree)


def torch_grads(tree):
    return jax.tree_util.tree_map(lambda t: t.grad.numpy(), tree)


def assert_trees_close(got, want, **tol):
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=jax.tree_util.keystr(path), **tol)


def check(fwd_j, fwd_t, from_jax, pj, gj, gt, x, y, loss_j=ce, loss_t=None):
    """Logits, loss and its gradients, both packages, from one JAX forward
    and backward: loss_j(logits, y) on the JAX side, the mean
    cross-entropy or loss_t(params) on the port's; the port's parameters
    from `from_jax`."""
    xj, xt = jnp.asarray(x), torch.from_numpy(x)

    def loss_and_logits(p):
        logits = fwd_j(p, gj, xj)
        return loss_j(logits, jnp.asarray(y)), logits

    (loss_want, want), grads_j = jax.value_and_grad(loss_and_logits, has_aux=True)(pj)
    pt = requires_grad(from_jax(pj, device="cpu"))
    got = fwd_t(pt, gt, xt)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    loss = F.cross_entropy(got, torch.from_numpy(y)) if loss_t is None else loss_t(pt)
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-5)
    loss.backward()
    assert_trees_close(torch_grads(pt), grads_j, **GRAD_TOL)
    return pt


@pytest.mark.parametrize("graph", ["power-law", "directed"])
def test_sage_matches_jax(graph):
    a = power_law() if graph == "power-law" else erdos_renyi_csr(N, 0.01, seed=2)
    gj, gt = graph_pair(a)
    pj = numpy_tree(jmodels.init_sage(jax.random.PRNGKey(0), D_IN, HIDDEN, CLASSES))
    x, y = inputs()
    pt = check(jmodels.sage_forward, vt.sage_forward, vt.sage_params_from_jax, pj, gj, gt, x, y)
    model = vt.SAGE.from_params(pt)
    with torch.no_grad():
        assert torch.equal(model(gt, torch.from_numpy(x)), vt.sage_forward(pt, gt,
                                                                           torch.from_numpy(x)))


def test_gin_matches_jax():
    gj, gt = graph_pair(power_law(seed=3), block_h=32)
    pj = numpy_tree(jmodels.init_gin(jax.random.PRNGKey(1), D_IN, HIDDEN, CLASSES))
    x, y = inputs(seed=4)
    check(jmodels.gin_forward, vt.gin_forward, vt.gin_params_from_jax, pj, gj, gt, x, y)


def test_appnp_matches_jax():
    gj, gt = graph_pair(power_law(seed=5))
    pj = numpy_tree(jmodels.init_appnp(jax.random.PRNGKey(2), D_IN, HIDDEN, CLASSES))
    x, y = inputs(seed=6)
    k, alpha = 5, 0.15
    check(lambda p, g, x: jmodels.appnp_forward(p, g, x, k=k, alpha=alpha),
          lambda p, g, x: vt.appnp_forward(p, g, x, k=k, alpha=alpha),
          vt.appnp_params_from_jax, pj, gj, gt, x, y,
          loss_t=lambda p: vt.appnp_loss(p, gt, torch.from_numpy(x), torch.from_numpy(y),
                                         k=k, alpha=alpha))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("residual,mode", [(True, "mean"), (False, "sym")])
def test_deep_gcn_matches_jax(remat, residual, mode):
    gj, gt = graph_pair(power_law(seed=7))
    pj = numpy_tree(jmodels.init_deep_gcn(jax.random.PRNGKey(3), D_IN, HIDDEN, CLASSES, 5))
    x, y = inputs(seed=8)
    kw = dict(remat=remat, residual=residual, mode=mode)
    check(lambda p, g, x: jmodels.deep_gcn_forward(p, g, x, **kw),
          lambda p, g, x: vt.deep_gcn_forward(p, g, x, **kw), vt.deep_gcn_params_from_jax,
          pj, gj, gt, x, y,
          loss_t=lambda p: vt.deep_gcn_loss(p, gt, torch.from_numpy(x), torch.from_numpy(y),
                                            **kw))


def test_deep_gcn_remat_same_bits_and_more_aggregations():
    """remat=True gives the same logits and gradients bit for bit and runs
    each hidden layer's aggregation again in the backward."""
    from voltrix_spmm_tpu_torch.ops import spmm_reference

    a = power_law(seed=9)
    _, gt = graph_pair(a)
    model = vt.DeepGCN(D_IN, HIDDEN, CLASSES, 6, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert tuple(model.params()["w_mid"].shape) == (4, HIDDEN, HIDDEN)
    x, y = inputs(seed=10)
    out = {}
    for remat in (False, True):
        model.zero_grad()
        spmm_reference.calls = 0
        loss = vt.deep_gcn_loss(model.params(), gt, torch.from_numpy(x), torch.from_numpy(y),
                                remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), {k: v.grad.clone() for k, v in model.params().items()},
                      spmm_reference.calls)
    assert torch.equal(out[False][0], out[True][0])
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k
    # 6 aggregations forward, 5 backward (x needs none), and 4 recomputed
    assert (out[False][2], out[True][2]) == (11, 15)


def test_deep_gcn_train_step_matches_optax():
    gj, gt = graph_pair(power_law(seed=11), block_h=32)
    pj = numpy_tree(jmodels.init_deep_gcn(jax.random.PRNGKey(4), D_IN, HIDDEN, CLASSES, 4))
    x, y = inputs(seed=12)
    opt = optax.adam(1e-2)
    step_j = jmodels.make_deep_train_step(opt, remat=True)
    new_j, _, loss_j = step_j(pj, opt.init(pj), gj, jnp.asarray(x), jnp.asarray(y))
    model = vt.DeepGCN.from_params(vt.deep_gcn_params_from_jax(pj, device="cpu"))
    step = vt.make_deep_train_step(torch.optim.Adam(model.parameters(), lr=1e-2), remat=True)
    loss = step(model.params(), gt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert_trees_close({k: v.detach().numpy() for k, v in model.params().items()}, new_j,
                       rtol=1e-4, atol=1e-6)


def masked_ce(logits, labels):
    """The JAX package's rgcn_loss on given logits (rgcn.py:80-88)."""
    mask = labels >= 0
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.maximum(labels, 0))
    return jnp.sum(jnp.where(mask, losses, 0.0)) / jnp.maximum(jnp.sum(mask), 1)


def relation_graphs(num_rels=3, seed=13):
    """A directed graph's edges split into relations by a seeded rng."""
    a = erdos_renyi_csr(N, 0.008, seed=seed)
    rel = np.random.default_rng(seed).integers(0, num_rels, a.nnz)
    pairs = []
    for r in range(num_rels):
        m = a.copy()
        m.data = (rel == r).astype(np.float32)
        m.eliminate_zeros()
        pairs.append(graph_pair(m.tocsr(), symmetric=False))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("num_bases", [None, 2])
def test_rgcn_matches_jax(num_bases):
    gjs, gts = relation_graphs()
    assert all(g.plan_t is not g.plan for g in gts)
    pj = numpy_tree(jmodels.init_rgcn(jax.random.PRNGKey(5), D_IN, HIDDEN, CLASSES, 3,
                                      num_bases=num_bases))
    x, y = inputs(seed=14)
    y = np.where(np.arange(N) % 4 == 0, -100, y)  # label -100: left out of the loss
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    check(jmodels.rgcn_forward, vt.rgcn_forward, vt.rgcn_params_from_jax, pj, gjs, gts, x, y,
          loss_j=masked_ce, loss_t=lambda p: vt.rgcn_loss(p, gts, xt, yt))


def test_rgcn_loss_without_labels_is_zero():
    _, gts = relation_graphs(num_rels=2, seed=15)
    model = vt.RGCN(D_IN, HIDDEN, CLASSES, 2, num_bases=2,
                    generator=torch.Generator().manual_seed(1), device="cpu")
    x, _ = inputs(seed=16)
    loss = vt.rgcn_loss(model.params(), gts, torch.from_numpy(x),
                        torch.full((N,), -100, dtype=torch.int64))
    assert loss.item() == 0.0


@pytest.mark.parametrize("make,shapes", [
    (lambda g: vt.SAGE(30, 8, 3, generator=g, device="cpu"),
     {"w_self1": (30, 8), "w_neigh2": (8, 3), "b1": (8,)}),
    (lambda g: vt.GIN(30, 8, 3, generator=g, device="cpu"),
     {"eps1": (), "w1a": (30, 8), "w2b": (8, 3)}),
    (lambda g: vt.APPNP(30, 8, 3, generator=g, device="cpu"), {"w1": (30, 8), "w2": (8, 3)}),
    (lambda g: vt.DeepGCN(30, 8, 3, 4, generator=g, device="cpu"),
     {"w_mid": (2, 8, 8), "b_mid": (2, 8), "w_out": (8, 3)}),
    (lambda g: vt.RGCN(30, 8, 3, 4, generator=g, device="cpu"),
     {"layers_0_w_rel": (4, 30, 8), "layers_1_w_self": (8, 3)}),
    (lambda g: vt.RGCN(30, 8, 3, 4, num_bases=2, generator=g, device="cpu"),
     {"layers_0_v_bases": (2, 30, 8), "layers_1_a_coef": (4, 2)}),
])
def test_model_init_from_generator(make, shapes):
    m1, m2, m3 = (make(torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    p1, p2, p3 = (dict(m.named_parameters()) for m in (m1, m2, m3))
    for name, shape in shapes.items():
        assert tuple(p1[name].shape) == shape, name
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert any(not torch.equal(p1[k], p3[k]) for k in p1)

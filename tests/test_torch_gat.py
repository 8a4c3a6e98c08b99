"""Parity of the PyTorch port's GAT (models/gat.py) and GCN training step
(models/gcn.py) with the JAX package on the CPU.

The same numpy graph, parameters, features and labels go through both
packages. The port aggregates through the plain versions of kernels K4
and K5 on CPU tensors; the JAX side runs its weighted Pallas kernels in
interpret mode. Logits and gradients are compared at rtol/atol 1e-4, as
tests/test_gat.py:69 does (edge softmax, two weighted SpMMs and dense
products summed in another order).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch.models import (
    edge_softmax,
    gat_attention_aggregate,
    gcn_loss,
    make_train_step,
)
from voltrix_spmm_tpu_torch.models.gat import edge_order, edge_orders
from voltrix_spmm_tpu_torch.ops import (
    spmm_reference,
    spmm_weighted_dvalues_reference,
    spmm_weighted_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = (32, 128)


def gat_csr(n=200, density=0.03, seed=0):
    """Symmetric with self-loops, the GAT convention of
    examples/train_gat.py:46-47 and tests/test_gat.py:23-28."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    a = ((a + a.T + sp.eye(n, format="csr")) != 0).astype(np.float32).tocsr()
    return a


def both_graphs(a, cfg=CFG):
    n = a.shape[0]
    gj = jmodels.build_gat_graph(a.indptr, a.indices, n, JaxPlanConfig(*cfg), backend="numpy")
    gt = vt.build_gat_graph(a.indptr, a.indices, n, vt.PlanConfig(*cfg), device="cpu")
    return gj, gt


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def gat_params(in_dim, hidden, classes, heads, seed):
    """`init_gat`'s layouts and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "w1": normal((heads, in_dim, hidden), (2.0 / in_dim) ** 0.5),
        "a1_src": normal((heads, hidden), hidden ** -0.5),
        "a1_dst": normal((heads, hidden), hidden ** -0.5),
        "w2": normal((heads * hidden, classes), (2.0 / (heads * hidden)) ** 0.5),
        "a2_src": normal((classes,), classes ** -0.5),
        "a2_dst": normal((classes,), classes ** -0.5),
    }


def jnp_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_gat_graph_matches_jax():
    a = gat_csr(seed=1)
    gj, gt = both_graphs(a)
    for name in ("slots", "slots_t", "rows", "cols"):
        t = getattr(gt, name)
        assert t.dtype == torch.int64, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(gj, name)), err_msg=name)
    for tp, jp in ((gt.plan, gj.plan), (gt.plan_t, gj.plan_t)):
        np.testing.assert_array_equal(tp.bitmask.numpy().view(np.uint32), np.asarray(jp.bitmask))
        np.testing.assert_array_equal(tp.hind.numpy(), np.asarray(jp.hind))
        assert tp.values is None and jp.values is None
    assert gt.num_nodes == gj.num_nodes == a.shape[0]


def test_build_gat_graph_refuses_inexact_lanes():
    a = gat_csr(seed=2)
    for cfg in (vt.PlanConfig(128, 128, gather_segment=8), vt.PlanConfig(128, 128, cluster_cols=True)):
        with pytest.raises(ValueError, match="exact-lane"):
            vt.build_gat_graph(a.indptr, a.indices, a.shape[0], cfg, device="cpu")


def test_edge_softmax_matches_jax():
    a = gat_csr(seed=3)
    gj, gt = both_graphs(a)
    e = np.random.default_rng(3).standard_normal(a.nnz).astype(np.float32) * 4
    out = edge_softmax(gt, torch.from_numpy(e))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmodels.edge_softmax(gj, jnp.asarray(e))),
                               rtol=1e-5, atol=1e-6)
    sums = np.zeros(a.shape[0])
    np.add.at(sums, gt.rows.numpy(), out.numpy())
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


def test_edge_softmax_gradient_matches_jax():
    """The softmax's backward sums each node's edge terms in CSR order
    (segment sums, no float atomics), rows without edges and a hub row
    included; its gradient is jax.grad's."""
    a = sp.csr_matrix(symmetrize(chung_lu_csr(300, 3000, seed=4)))
    a = (sp.diags((np.arange(300) % 7 != 3).astype(np.float32)) @ a).tocsr()
    a.eliminate_zeros()
    gj, gt = both_graphs(a)
    assert int(np.diff(a.indptr).max()) > 50 and (np.diff(a.indptr) == 0).any()
    rng = np.random.default_rng(5)
    e = rng.standard_normal(a.nnz).astype(np.float32) * 4
    w = rng.standard_normal(a.nnz).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jmodels.edge_softmax(gj, x) * w))(jnp.asarray(e))
    et = torch.from_numpy(e).requires_grad_(True)
    (edge_softmax(gt, et) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("f", [8, 40])
def test_gat_head_matches_jax(f):
    a = gat_csr(seed=4)
    gj, gt = both_graphs(a)
    n = a.shape[0]
    h = features(n, f, seed=5)
    a_src, a_dst = features(1, f, seed=6)[0], features(1, f, seed=7)[0]
    ref = np.asarray(jmodels.gat_attention_aggregate(gj, jnp.asarray(h), jnp.asarray(a_src),
                                                     jnp.asarray(a_dst)))
    args = (gt, torch.from_numpy(h), torch.from_numpy(a_src), torch.from_numpy(a_dst))
    calls = spmm_weighted_reference.calls
    out = gat_attention_aggregate(*args)
    assert spmm_weighted_reference.calls == calls + 1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    with torch.no_grad():  # no transpose plane; the same logits
        assert torch.equal(gat_attention_aggregate(*args), out)


def test_gat_forward_matches_jax():
    a = gat_csr(seed=8)
    gj, gt = both_graphs(a)
    n = a.shape[0]
    p = gat_params(12, 8, 5, heads=2, seed=8)
    x = features(n, 12, seed=9)
    ref = np.asarray(jmodels.gat_forward(jnp_params(p), gj, jnp.asarray(x)))
    model = vt.GAT.from_params(vt.gat_params_from_jax(p, device="cpu")).eval()
    k4 = spmm_weighted_reference.calls
    with torch.no_grad():
        out = model(gt, torch.from_numpy(x))
    assert spmm_weighted_reference.calls == k4 + 3  # one per head, and the output head
    assert out.shape == (n, 5) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    with torch.no_grad():
        assert torch.equal(model(gt, torch.from_numpy(x), impl="reference"), out)


def test_gat_loss_gradients_match_jax():
    a = gat_csr(n=150, seed=10)
    gj, gt = both_graphs(a)
    n = a.shape[0]
    p = gat_params(12, 8, 4, heads=2, seed=10)
    x = features(n, 12, seed=11)
    y = np.random.default_rng(12).integers(0, 4, size=n)
    loss_j, grads_j = jax.value_and_grad(jmodels.gat_loss)(jnp_params(p), gj, jnp.asarray(x),
                                                           jnp.asarray(y))
    pt = {k: v.requires_grad_(True) for k, v in vt.gat_params_from_jax(p, device="cpu").items()}
    k4, k5 = spmm_weighted_reference.calls, spmm_weighted_dvalues_reference.calls
    loss = vt.gat_loss(pt, gt, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    # forward 3 K4; backward 3 K4 over plan_t and 3 K5
    assert (spmm_weighted_reference.calls - k4, spmm_weighted_dvalues_reference.calls - k5) == (6, 3)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(grads_j[k]), **TOL, err_msg=k)


def test_gat_adam_steps_lower_the_loss():
    a = gat_csr(seed=13)
    _, gt = both_graphs(a)
    n = a.shape[0]
    model = vt.GAT(12, 8, 4, num_heads=2, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    x = torch.from_numpy(features(n, 12, seed=14))
    y = torch.from_numpy(np.random.default_rng(15).integers(0, 4, size=n))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_loss)
    losses = [step(model.params(), gt, x, y).item() for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for p in model.parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())


def test_gat_init_from_generator():
    def make(seed):
        return vt.GAT(300, 16, 10, num_heads=3, generator=torch.Generator().manual_seed(seed),
                      device="cpu")

    m1, m2, m3 = make(0), make(0), make(1)
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
    assert not torch.equal(m1.w1, m3.w1)
    shapes = {k: tuple(v.shape) for k, v in m1.params().items()}
    assert shapes == {"w1": (3, 300, 16), "a1_src": (3, 16), "a1_dst": (3, 16),
                      "w2": (48, 10), "a2_src": (10,), "a2_dst": (10,)}
    assert abs(m1.w1.std().item() / (2 / 300) ** 0.5 - 1) < 0.05
    assert abs(m1.a1_src.std().item() / 16 ** -0.5 - 1) < 0.3


def test_gat_params_from_jax_keeps_layouts():
    p = {k: np.asarray(v) for k, v in
         jmodels.init_gat(jax.random.PRNGKey(2), 20, 8, 5, num_heads=3).items()}
    t = vt.gat_params_from_jax(p, device="cpu")
    assert set(t) == set(p)
    for k, v in t.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), p[k])
    model = vt.GAT.from_params(t)
    assert [name for name, _ in model.named_parameters()] == list(vt.models.gat.PARAM_NAMES)


@pytest.mark.parametrize("fn,arg", [
    (vt.build_graph, "device"), (vt.gcn_params_from_jax, "device"), (vt.GCN, "device"),
    (vt.build_gat_graph, "device"), (vt.gat_params_from_jax, "device"), (vt.GAT, "device"),
])
def test_entry_points_default_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_gat_slice_matches_jax():
    """Path D of chip_smoke.py at a small size: a symmetric power-law graph
    with self-loops, PlanConfig(64, 128), 2 heads; three requests (one K4
    per head and one for the output head, no K5), then one training step
    (twice the K4 and one K5 per head) whose gradients match jax.grad."""
    a = symmetrize(chung_lu_csr(1500, 6000, seed=16))
    a = ((a + sp.eye(a.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    n = a.shape[0]
    gj, gt = both_graphs(a, (64, 128))
    p = gat_params(32, 8, 6, heads=2, seed=16)
    model = vt.GAT.from_params(vt.gat_params_from_jax(p, device="cpu"))
    for request in range(3):
        x = features(n, 32, seed=20 + request)
        calls = (spmm_weighted_reference.calls, spmm_weighted_dvalues_reference.calls)
        with torch.no_grad():
            out = model(gt, torch.from_numpy(x))
        assert (spmm_weighted_reference.calls - calls[0],
                spmm_weighted_dvalues_reference.calls - calls[1]) == (3, 0)
        ref = jmodels.gat_forward(jnp_params(p), gj, jnp.asarray(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    y = np.random.default_rng(17).integers(0, 6, size=n)
    grads_j = jax.grad(jmodels.gat_loss)(jnp_params(p), gj, jnp.asarray(x), jnp.asarray(y))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_loss)
    calls = (spmm_weighted_reference.calls, spmm_weighted_dvalues_reference.calls)
    step(model.params(), gt, torch.from_numpy(x), torch.from_numpy(y))
    assert (spmm_weighted_reference.calls - calls[0],
            spmm_weighted_dvalues_reference.calls - calls[1]) == (6, 3)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads_j[k]), **TOL, err_msg=k)


def hub_graph():
    """300 nodes, power-law with self-loops: a hub row of > 50 edges and
    rows 3, 10, 17, ... left without any edge."""
    a = sp.csr_matrix(symmetrize(chung_lu_csr(300, 3000, seed=4)))
    a = ((a + sp.eye(300, format="csr")) != 0).astype(np.float32)
    keep = sp.diags((np.arange(300) % 7 != 3).astype(np.float32))
    a = (keep @ a @ keep).tocsr()
    a.eliminate_zeros()
    assert int(np.diff(a.indptr).max()) > 50 and (np.diff(a.indptr) == 0).any()
    return a


def permuted(gj, gt, seed):
    """Both packages' graphs with the edge arrays (rows, cols, slots,
    slots_t) permuted by one permutation, and the permutation."""
    perm = np.random.default_rng(seed).permutation(gt.rows.numel())
    edges = ("rows", "cols", "slots", "slots_t")
    gj_p = dataclasses.replace(gj, **{k: getattr(gj, k)[jnp.asarray(perm)] for k in edges})
    gt_p = dataclasses.replace(gt, **{k: getattr(gt, k)[torch.from_numpy(perm)] for k in edges})
    return gj_p, gt_p, perm


def test_edge_order_is_built_once_per_tensor():
    """Sorted rows keep the edges where they are (no gather); unsorted
    ones get a stable argsort. The order is kept beside its tensor: a
    graph copy sharing it finds it, a copy with new rows builds its own."""
    gj, gt = both_graphs(hub_graph(), (64, 128))
    by_rows, by_cols = edge_orders(gt)
    assert by_rows.perm is None and by_cols.perm is not None
    assert edge_orders(dataclasses.replace(gt, slots=gt.slots.clone()))[0] is by_rows
    assert edge_order(gt.cols, gt.num_nodes) is by_cols
    np.testing.assert_array_equal(by_cols.perm.numpy(),
                                  np.argsort(gt.cols.numpy(), kind="stable"))
    counts = np.bincount(gt.cols.numpy(), minlength=gt.num_nodes)
    np.testing.assert_array_equal(np.diff(by_cols.offsets.numpy()), counts)
    _, gt_p, _ = permuted(gj, gt, seed=1)
    mine = edge_orders(gt_p)[0]
    assert mine is not by_rows and mine.perm is not None
    np.testing.assert_array_equal(np.diff(mine.offsets.numpy()), np.diff(by_rows.offsets.numpy()))


def test_edge_softmax_on_sorted_rows_keeps_its_bits():
    """On CSR-ordered rows the softmax runs the same reductions as before
    the edge order existed (offsets by searchsorted, segment max and sums
    in CSR order), bit for bit."""
    a = hub_graph()
    _, gt = both_graphs(a, (64, 128))
    e = torch.from_numpy(np.random.default_rng(6).standard_normal(a.nnz).astype(np.float32) * 4)
    rows = gt.rows
    offsets = torch.searchsorted(rows, torch.arange(gt.num_nodes + 1))
    m = torch.segment_reduce(e, "max", offsets=offsets, unsafe=True)
    alpha = torch.exp(e - m.index_select(0, rows))
    denom = torch.segment_reduce(alpha, "sum", offsets=offsets, unsafe=True)
    assert torch.equal(edge_softmax(gt, e), alpha / denom.index_select(0, rows).clamp_min(1e-9))


def test_edge_softmax_on_permuted_edges_matches_jax():
    """Edges out of CSR order: JAX's softmax, forward and gradient, on the
    same permuted graph, and the sorted graph's softmax permuted."""
    a = hub_graph()
    gj, gt = both_graphs(a, (64, 128))
    gj_p, gt_p, perm = permuted(gj, gt, seed=7)
    rng = np.random.default_rng(8)
    e = rng.standard_normal(a.nnz).astype(np.float32) * 4
    w = rng.standard_normal(a.nnz).astype(np.float32)
    e_p, w_p = e[perm], w[perm]
    et = torch.from_numpy(e_p).requires_grad_(True)
    out = edge_softmax(gt_p, et)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jmodels.edge_softmax(gj_p, jnp.asarray(e_p))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(),
                               edge_softmax(gt, torch.from_numpy(e)).numpy()[perm],
                               rtol=1e-5, atol=1e-6)
    (out * torch.from_numpy(w_p)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jmodels.edge_softmax(gj_p, x) * w_p))(jnp.asarray(e_p))
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("order", ["sorted", "permuted"])
def test_gat_head_gradients_match_jax(order):
    """One attention head on the hub graph, its edges in CSR order or
    permuted: the output and the gradients of h, a_src and a_dst (through
    the logits' gathers, whose backward sums in each node's edge order)
    against jax.grad."""
    a = hub_graph()
    gj, gt = both_graphs(a, (64, 128))
    if order == "permuted":
        gj, gt, _ = permuted(gj, gt, seed=9)
    n, f = a.shape[0], 8
    h, w = features(n, f, seed=10), features(n, f, seed=11)
    a_src, a_dst = features(1, f, seed=12)[0], features(1, f, seed=13)[0]

    def jloss(h, a_src, a_dst):
        return jnp.sum(jmodels.gat_attention_aggregate(gj, h, a_src, a_dst) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(h), jnp.asarray(a_src),
                                             jnp.asarray(a_dst))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (h, a_src, a_dst)]
    out = gat_attention_aggregate(gt, *leaves)
    ref = jmodels.gat_attention_aggregate(gj, jnp.asarray(h), jnp.asarray(a_src),
                                          jnp.asarray(a_dst))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, g in zip(("h", "a_src", "a_dst"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **TOL, err_msg=name)


def test_gat_on_permuted_edges_matches_jax():
    """gat_forward and gat_loss's gradients on the permuted hub graph
    against the JAX package on the same permuted graph."""
    a = hub_graph()
    gj, gt = both_graphs(a, (64, 128))
    gj, gt, _ = permuted(gj, gt, seed=14)
    n = a.shape[0]
    p = gat_params(12, 8, 4, heads=2, seed=15)
    x = features(n, 12, seed=16)
    y = np.random.default_rng(17).integers(0, 4, size=n)
    ref = np.asarray(jmodels.gat_forward(jnp_params(p), gj, jnp.asarray(x)))
    pt = {k: v.requires_grad_(True) for k, v in vt.gat_params_from_jax(p, device="cpu").items()}
    out = vt.gat_forward(pt, gt, torch.from_numpy(x))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    loss_j, grads_j = jax.value_and_grad(jmodels.gat_loss)(jnp_params(p), gj, jnp.asarray(x),
                                                           jnp.asarray(y))
    loss = vt.gat_loss(pt, gt, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(grads_j[k]), **TOL, err_msg=k)


def gcn_problem(seed):
    a = symmetrize(chung_lu_csr(800, 3000, seed=seed))
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(128, 128), backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(128, 128), device="cpu")
    rng = np.random.default_rng(seed)
    p = {
        "w1": (rng.standard_normal((32, 16)) * (2 / 32) ** 0.5).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(16)).astype(np.float32),
        "w2": (rng.standard_normal((16, 5)) * (2 / 16) ** 0.5).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(5)).astype(np.float32),
    }
    x = features(n, 32, seed + 1)
    y = rng.integers(0, 5, size=n)
    return gj, gt, p, x, y


def test_gcn_loss_matches_jax():
    gj, gt, p, x, y = gcn_problem(seed=18)
    ref = jmodels.gcn_loss(jnp_params(p), gj, jnp.asarray(x), jnp.asarray(y))
    out = gcn_loss(vt.gcn_params_from_jax(p, device="cpu"), gt, torch.from_numpy(x),
                   torch.from_numpy(y))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


def test_gcn_sgd_step_matches_jax():
    """One step of make_train_step(SGD) against the JAX package's
    make_train_step(optax.sgd): the loss, the updated parameters, and the
    aggregations: two in the forward and one in the backward of layer 2
    (x needs no gradient)."""
    gj, gt, p, x, y = gcn_problem(seed=19)
    lr = 0.1
    tx = optax.sgd(lr)
    pj = jnp_params(p)
    pj_new, _, loss_j = jmodels.make_train_step(tx)(pj, tx.init(pj), gj, jnp.asarray(x),
                                                    jnp.asarray(y))
    model = vt.GCN.from_params(vt.gcn_params_from_jax(p, device="cpu"))
    step = make_train_step(torch.optim.SGD(model.parameters(), lr=lr))
    calls = spmm_reference.calls
    loss = step(model.params(), gt, torch.from_numpy(x), torch.from_numpy(y))
    assert spmm_reference.calls == calls + 3
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(pj_new[k]), **TOL, err_msg=k)

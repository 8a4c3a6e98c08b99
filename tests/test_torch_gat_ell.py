"""Parity of the PyTorch port's dot-product GAT on the ELL plan
(models/gat_ell.py) with the JAX package on the CPU.

The same numpy graph, parameters, features and labels go through both
packages. The port runs the plain versions of kernels K6 and K7 on CPU
tensors; the JAX side runs its ELL Pallas kernels in interpret mode. Both
run the same algorithm (SDDMM scores, edge softmax, ELL aggregation), so
logits, losses, gradients and one Adam step are held at rtol/atol 1e-4,
tests/test_linkpred.py:74's tolerance for SDDMM scores and the port's GAT
tolerance (tests/test_torch_gat.py); tests/test_gat_ell.py allows 1e-3
(logits) and 2e-3 (gradients) against a dense oracle.
"""

import functools
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
import voltrix_spmm_tpu_torch.models as tmodels
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch.models import dot_attention_aggregate, make_train_step
from voltrix_spmm_tpu_torch.ops import spmm_ell_dvals_reference, spmm_ell_reference

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = (64, 128)


def gat_csr(n=160, density=0.03, seed=0):
    """Symmetric with self-loops, tests/test_gat_ell.py:22-26's graph."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    return ((a + a.T + sp.eye(n, format="csr")) != 0).astype(np.float32).tocsr()


def both_graphs(a, cfg=CFG, unroll=1):
    n = a.shape[0]
    gj = jmodels.build_ell_graph(a.indptr, a.indices, n, JaxPlanConfig(*cfg, block_unroll=unroll))
    gt = vt.build_ell_graph(a.indptr, a.indices, n, vt.PlanConfig(*cfg, block_unroll=unroll),
                            device="cpu")
    return gj, gt


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def gat_dot_params(in_dim, hidden, classes, heads, seed):
    """`init_gat_dot`'s layouts and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    h2 = heads * hidden

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)

    p = {k: normal((heads, in_dim, hidden), in_dim) for k in ("wq1", "wk1", "wv1")}
    p.update({k: normal((h2, classes), h2) for k in ("wq2", "wk2", "wv2")})
    return p


def jnp_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def counts():
    return spmm_ell_reference.calls, spmm_ell_dvals_reference.calls


def since(before):
    now = counts()
    return now[0] - before[0], now[1] - before[1]


def test_ell_graph_matches_jax():
    a = gat_csr(seed=1)
    gj, gt = both_graphs(a, unroll=4)
    for tp, jp in ((gt.plan, gj.plan), (gt.plan_t, gj.plan_t)):
        for name in ("hind", "erow", "vals", "window_of_block", "block_ptr", "edge_lane",
                     "lane_edge"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)), err_msg=name)
        assert tp.total_blocks % 4 == 0
    for name in ("rows", "cols"):
        t = getattr(gt, name)
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(gj, name)), err_msg=name)
    assert gt.num_nodes == gj.num_nodes == a.shape[0]
    assert tmodels.gat_ell.edge_softmax is tmodels.gat.edge_softmax  # one softmax, reused


@pytest.mark.parametrize("f", [8, 40])
def test_dot_head_matches_jax(f):
    a = gat_csr(seed=2)
    gj, gt = both_graphs(a)
    n = a.shape[0]
    q, k, v = (features(n, f, seed=s) for s in (3, 4, 5))
    ref = np.asarray(jmodels.dot_attention_aggregate(gj, jnp.asarray(q), jnp.asarray(k),
                                                     jnp.asarray(v)))
    args = (gt, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    before = counts()
    out = dot_attention_aggregate(*args)
    assert since(before) == (1, 1)  # K7 for the scores, K6 for the aggregation
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    with torch.no_grad():  # no A^T lanes; the same output
        assert torch.equal(dot_attention_aggregate(*args), out)


def test_dot_head_gradients_match_jax():
    a = gat_csr(n=120, seed=6)
    gj, gt = both_graphs(a)
    n, f = a.shape[0], 12
    q, k, v = (features(n, f, seed=s) for s in (7, 8, 9))
    w = features(n, f, seed=10)

    def jloss(q_, k_, v_):
        return jnp.sum(jnp.sin(jmodels.dot_attention_aggregate(gj, q_, k_, v_)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt_ = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = counts()
    (torch.sin(dot_attention_aggregate(gt, qt, kt, vt_)) * torch.from_numpy(w)).sum().backward()
    # forward K7 + K6; backward K6 over A^T (v), K7 (attention), 2 K6 (q, k)
    assert since(before) == (4, 2)
    for got, ref in zip((qt.grad, kt.grad, vt_.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gat_dot_forward_matches_jax():
    a = gat_csr(seed=11)
    gj, gt = both_graphs(a)
    n = a.shape[0]
    p = gat_dot_params(12, 8, 5, heads=2, seed=11)
    x = features(n, 12, seed=12)
    ref = np.asarray(jmodels.gat_dot_forward(jnp_params(p), gj, jnp.asarray(x)))
    model = vt.GATDot.from_params(vt.gat_dot_params_from_jax(p, device="cpu")).eval()
    before = counts()
    with torch.no_grad():
        out = model(gt, torch.from_numpy(x))
    assert since(before) == (3, 3)  # one K6 and one K7 per head, and the output head
    assert out.shape == (n, 5) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    with torch.no_grad():
        assert torch.equal(model(gt, torch.from_numpy(x), impl="reference"), out)


@functools.cache
def loss_problem():
    """A graph, parameters, features and labels, and the JAX package's
    gat_dot_loss and its gradients on them (shared by two tests)."""
    a = gat_csr(n=120, seed=13)
    gj, gt = both_graphs(a)
    n = a.shape[0]
    p = gat_dot_params(12, 8, 4, heads=2, seed=13)
    x = features(n, 12, seed=14)
    y = np.random.default_rng(15).integers(0, 4, size=n)
    loss_j, grads_j = jax.value_and_grad(jmodels.gat_dot_loss)(jnp_params(p), gj,
                                                               jnp.asarray(x), jnp.asarray(y))
    return gt, p, x, y, float(loss_j), {k: np.asarray(v) for k, v in grads_j.items()}


def test_gat_dot_loss_gradients_match_jax():
    gt, p, x, y, loss_j, grads_j = loss_problem()
    pt = {k: v.requires_grad_(True) for k, v in vt.gat_dot_params_from_jax(p, device="cpu").items()}
    before = counts()
    loss = vt.gat_dot_loss(pt, gt, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert since(before) == (12, 6)  # per head: K6 4 times, K7 twice
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), grads_j[k], **TOL, err_msg=k)


def test_gat_dot_adam_step_matches_optax():
    """One step of make_train_step(Adam, gat_dot_loss) against optax.adam
    applied to the JAX package's gat_dot_loss gradients: the loss and the
    updated parameters."""
    gt, p, x, y, loss_j, grads_j = loss_problem()
    tx = optax.adam(5e-3)
    pj = jnp_params(p)
    updates, _ = tx.update(jnp_params(grads_j), tx.init(pj), pj)
    pj_new = optax.apply_updates(pj, updates)
    model = vt.GATDot.from_params(vt.gat_dot_params_from_jax(p, device="cpu"))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_dot_loss)
    loss = step(model.params(), gt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(pj_new[k]), **TOL, err_msg=k)


def test_gat_dot_adam_steps_lower_the_loss():
    a = gat_csr(seed=19)
    _, gt = both_graphs(a, (128, 128), unroll=4)
    n = a.shape[0]
    model = vt.GATDot(10, 8, 4, num_heads=2, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    x = torch.from_numpy(features(n, 10, seed=20))
    y = torch.from_numpy(np.random.default_rng(21).integers(0, 4, size=n))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_dot_loss)
    losses = [step(model.params(), gt, x, y).item() for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for p in model.parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())


def test_gat_dot_init_from_generator():
    def make(seed):
        return vt.GATDot(300, 16, 10, num_heads=3, generator=torch.Generator().manual_seed(seed),
                         device="cpu")

    m1, m2, m3 = make(0), make(0), make(1)
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
    assert not torch.equal(m1.wq1, m3.wq1)
    shapes = {k: tuple(v.shape) for k, v in m1.params().items()}
    assert shapes == {"wq1": (3, 300, 16), "wk1": (3, 300, 16), "wv1": (3, 300, 16),
                      "wq2": (48, 10), "wk2": (48, 10), "wv2": (48, 10)}
    assert abs(m1.wk1.std().item() / (2 / 300) ** 0.5 - 1) < 0.05
    assert abs(m1.wv2.std().item() / (2 / 48) ** 0.5 - 1) < 0.1


def test_gat_dot_params_from_jax_keeps_layouts():
    p = {k: np.asarray(v) for k, v in
         jmodels.init_gat_dot(jax.random.PRNGKey(2), 20, 8, 5, num_heads=3).items()}
    t = vt.gat_dot_params_from_jax(p, device="cpu")
    assert set(t) == set(p)
    for k, v in t.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), p[k])
    model = vt.GATDot.from_params(t)
    assert [name for name, _ in model.named_parameters()] == list(tmodels.gat_ell.PARAM_NAMES)


@pytest.mark.parametrize("fn", [vt.build_ell_graph, vt.gat_dot_params_from_jax, vt.GATDot,
                                vt.build_link_candidates, vt.init_link_predictor])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_gat_ell_slice_matches_jax():
    """Path E of chip_smoke.py at a small size: a symmetric power-law graph
    with self-loops, PlanConfig(128, 128, block_unroll=4), 2 heads; three
    requests (one K6 and one K7 per head and for the output head; the
    first held against JAX), then one Adam step (K6 4 and K7 2 times per
    head) whose gradients match jax.grad."""
    a = symmetrize(chung_lu_csr(600, 2400, seed=22))
    a = ((a + sp.eye(a.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    n = a.shape[0]
    gj, gt = both_graphs(a, (128, 128), unroll=4)
    p = gat_dot_params(32, 8, 6, heads=2, seed=22)
    model = vt.GATDot.from_params(vt.gat_dot_params_from_jax(p, device="cpu"))
    for request in range(3):
        x = features(n, 32, seed=30 + request)
        before = counts()
        with torch.no_grad():
            out = model(gt, torch.from_numpy(x))
        assert since(before) == (3, 3)
        if request == 0:
            ref = jmodels.gat_dot_forward(jnp_params(p), gj, jnp.asarray(x))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    y = np.random.default_rng(23).integers(0, 6, size=n)
    grads_j = jax.grad(jmodels.gat_dot_loss)(jnp_params(p), gj, jnp.asarray(x), jnp.asarray(y))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_dot_loss)
    before = counts()
    step(model.params(), gt, torch.from_numpy(x), torch.from_numpy(y))
    assert since(before) == (12, 6)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads_j[k]), **TOL, err_msg=k)

"""Parity of the PyTorch port's flash GAT (models/gat_flash.py) with the
JAX package on the CPU.

The same numpy graph, parameters, features and labels go through both
packages. The port runs the plain versions of kernels K13, K14 and K15
(with a transpose plan) or K9 and K10 (a bare plan, the per-head path) on
CPU tensors; the JAX side runs its Pallas kernels in interpret mode. Logits, losses, gradients and one optimizer step are held at
rtol/atol 1e-4 with float32 planes and with bf16 planes, where both
packages round the same operands (the JAX package carries the backward's
softmax statistics as hi/lo bf16 pairs, the port in float32: ~2^-16
relative). Flash GAT against the port's dot-product GAT on the ELL plan
uses tests/test_gat_flash.py:57-58's rtol/atol 5e-4.
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
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.format import csr_preprocess as jax_csr_preprocess
from voltrix_spmm_tpu_torch.models import flash_attention_aggregate, make_train_step
from voltrix_spmm_tpu_torch.models.gat_flash import BF16_PLANE_ROWS, _plane_dtype
from voltrix_spmm_tpu_torch.ops import (
    attention_bwd_reference,
    attention_mh_dkv_reference,
    attention_mh_dq_reference,
    spmm_attention_mh_reference,
    spmm_attention_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 planes through two layers: float32 noise in layer 1's output can move
# a layer-2 input across a bf16 rounding boundary in one package and not in
# the other, one bf16 ulp (2**-8 relative); JAX's own bf16-plane tolerance
# (tests/test_attention.py:468-470)
BF16_MODEL_TOL = dict(rtol=2e-2, atol=2e-2)
PLANES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def gat_csr(n=150, density=0.03, seed=0, directed=False):
    """Self-loops, symmetric unless directed (tests/test_gat_flash.py:25-29)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    a.data[:] = 1.0
    a = a if directed else a + a.T
    a = ((a + sp.eye(n, format="csr")) != 0).astype(np.float32).tocsr()
    a.sort_indices()
    return a


def plan_pairs(a, cfg=(64, 128), unroll=1):
    """((JAX plan, JAX plan_t), (port plan, port plan_t))."""
    n = a.shape[0]
    at = a.T.tocsr()
    jc, tc = JaxPlanConfig(*cfg, block_unroll=unroll), vt.PlanConfig(*cfg, block_unroll=unroll)
    return ((jax_csr_preprocess(a.indptr, a.indices, n, jc),
             jax_csr_preprocess(at.indptr, at.indices, n, jc)),
            (vt.csr_preprocess(a.indptr, a.indices, n, tc),
             vt.csr_preprocess(at.indptr, at.indices, n, tc)))


def with_plane(pair, dtype):
    return pair if dtype is None else (*pair, dtype)


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def params_np(in_dim, hidden, classes, heads, seed):
    """`init_gat_flash`'s (= `init_gat_dot`'s) layouts and scales, with numpy."""
    rng = np.random.default_rng(seed)
    h2 = heads * hidden

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5).astype(np.float32)

    p = {k: normal((heads, in_dim, hidden), in_dim) for k in ("wq1", "wk1", "wv1")}
    p.update({k: normal((h2, classes), h2) for k in ("wq2", "wk2", "wv2")})
    return p


def jnp_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def calls():
    return (spmm_attention_mh_reference.calls, attention_mh_dq_reference.calls,
            attention_mh_dkv_reference.calls)


def since(before):
    return tuple(a - b for a, b in zip(calls(), before))


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("directed", [False, True], ids=["sym", "directed"])
def test_forward_matches_jax(directed, plane):
    a = gat_csr(seed=1, directed=directed)
    jg, tg = plan_pairs(a)
    jdt, tdt = PLANES[plane]
    p = params_np(12, 8, 5, heads=3, seed=2)
    x = features(a.shape[0], 12, seed=3)
    ref = jmodels.gat_flash_forward(jnp_params(p), with_plane(jg, jdt), jnp.asarray(x))
    model = vt.GATFlash.from_params(vt.gat_flash_params_from_jax(p, device="cpu")).eval()
    before = calls()
    with torch.no_grad():
        out = model(with_plane(tg, tdt), torch.from_numpy(x))
    assert since(before) == (2, 0, 0)  # one K13 per layer, every head at once
    assert out.shape == (a.shape[0], 5) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_graph_data_and_plane_rule():
    """A GraphData (plan_t is plan on a symmetric graph) gives what the
    (plan, plan_t) pair gives; below 65,536 rows the planes are float32, so
    naming torch.float32 changes nothing, and bf16 changes the result."""
    a = gat_csr(seed=4)
    n = a.shape[0]
    g = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(64, 128), device="cpu")
    assert g.plan_t is g.plan
    p = vt.gat_flash_params_from_jax(params_np(10, 8, 4, heads=2, seed=5), device="cpu")
    x = torch.from_numpy(features(n, 10, seed=6))
    with torch.no_grad():
        base = vt.gat_flash_forward(p, g, x)
        assert torch.equal(vt.gat_flash_forward(p, (g.plan, g.plan_t), x), base)
        assert torch.equal(vt.gat_flash_forward(p, (g.plan, g.plan_t, torch.float32), x), base)
        bf16 = vt.gat_flash_forward(p, (g.plan, g.plan_t, torch.bfloat16), x)
        assert not torch.equal(bf16, base)
    assert BF16_PLANE_ROWS == 65536
    assert _plane_dtype(None, 65535) is None and _plane_dtype(None, 65536) == torch.bfloat16
    assert _plane_dtype(torch.float32, 10**6) is None
    assert _plane_dtype(torch.bfloat16, 10) == torch.bfloat16


@functools.cache
def loss_problem(plane):
    """A directed graph, parameters, features and labels, and the JAX
    package's gat_flash_loss and gradients on them."""
    a = gat_csr(n=100, density=0.04, seed=7, directed=True)
    jg, tg = plan_pairs(a, (64, 128), unroll=2)
    jdt, tdt = PLANES[plane]
    p = params_np(12, 8, 4, heads=2, seed=8)
    x = features(a.shape[0], 12, seed=9)
    y = np.random.default_rng(10).integers(0, 4, size=a.shape[0])
    loss, grads = jax.value_and_grad(jmodels.gat_flash_loss)(
        jnp_params(p), with_plane(jg, jdt), jnp.asarray(x), jnp.asarray(y))
    return (with_plane(jg, jdt), with_plane(tg, tdt), p, x, y, float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("plane", ["f32", "bf16"])
def test_loss_gradients_match_jax(plane):
    _, tg, p, x, y, loss_j, grads_j = loss_problem(plane)
    pt = {k: v.requires_grad_(True)
          for k, v in vt.gat_flash_params_from_jax(p, device="cpu").items()}
    before = calls()
    loss = vt.gat_flash_loss(pt, tg, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert since(before) == (2, 2, 2)  # per layer: K13, then K14 and K15
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), grads_j[k], **TOL, err_msg=k)


def test_adam_step_matches_optax():
    """One step of make_train_step(Adam, gat_flash_loss) against optax.adam
    on the JAX package's gradients: the loss and the updated parameters."""
    _, tg, p, x, y, loss_j, grads_j = loss_problem("f32")
    tx = optax.adam(5e-3)
    pj = jnp_params(p)
    updates, _ = tx.update(jnp_params(grads_j), tx.init(pj), pj)
    pj_new = optax.apply_updates(pj, updates)
    model = vt.GATFlash.from_params(vt.gat_flash_params_from_jax(p, device="cpu"))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_flash_loss)
    loss = step(model.params(), tg, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(pj_new[k]), **TOL, err_msg=k)


def test_sgd_step_matches_jax():
    """make_gat_flash_train_step(lr): the JAX package's SGD step; the
    parameters it was given are left as they were."""
    jg, tg, p, x, y, loss_j, _ = loss_problem("f32")
    step_j = jmodels.make_gat_flash_train_step(lr=5e-2)
    pj_new, loss_jj = step_j(jnp_params(p), jg, jnp.asarray(x), jnp.asarray(y))
    pt = vt.gat_flash_params_from_jax(p, device="cpu")
    pt_new, loss = vt.make_gat_flash_train_step(lr=5e-2)(pt, tg, torch.from_numpy(x),
                                                         torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(loss_jj), rtol=1e-5)
    for k in pt:
        np.testing.assert_array_equal(pt[k].numpy(), p[k])
        assert not pt_new[k].requires_grad
        np.testing.assert_allclose(pt_new[k].numpy(), np.asarray(pj_new[k]), **TOL, err_msg=k)


def test_matches_gat_dot():
    """On deduplicated adjacency the fused model and the three-pass ELL
    model compute the same function with the same parameters."""
    a = gat_csr(n=160, seed=11)
    n = a.shape[0]
    _, tg = plan_pairs(a)
    ell = vt.build_ell_graph(a.indptr, a.indices, n, vt.PlanConfig(64, 128), device="cpu")
    p = vt.gat_flash_params_from_jax(params_np(10, 8, 5, heads=2, seed=12), device="cpu")
    x = torch.from_numpy(features(n, 10, seed=13))
    with torch.no_grad():
        flash = vt.GATFlash.from_params(p)(tg, x)
        dot = vt.GATDot.from_params(p)(ell, x)
    np.testing.assert_allclose(flash.numpy(), dot.numpy(), rtol=5e-4, atol=5e-4)


def single_calls():
    """Calls of K9's and K10's plain versions, and of K13's."""
    return (spmm_attention_reference.calls, attention_bwd_reference.calls,
            spmm_attention_mh_reference.calls)


def single_since(before):
    return tuple(a - b for a, b in zip(single_calls(), before))


def test_bare_plan_forward_matches_jax():
    """A bare plan takes the per-head path (tests/test_gat_flash.py:48-59's
    form): one K9 per head and one for layer 2, none of K13."""
    a = gat_csr(n=160, seed=14)
    jg, tg = plan_pairs(a)
    p = params_np(10, 8, 5, heads=2, seed=15)
    x = features(a.shape[0], 10, seed=16)
    ref = jmodels.gat_flash_forward(jnp_params(p), jg[0], jnp.asarray(x))
    model = vt.GATFlash.from_params(vt.gat_flash_params_from_jax(p, device="cpu")).eval()
    before = single_calls()
    with torch.no_grad():
        out = model(tg[0], torch.from_numpy(x))
    assert single_since(before) == (3, 0, 0)
    assert out.shape == (a.shape[0], 5) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plan_t_none_takes_the_float32_per_head_path():
    """(plan, None) and (plan, None, torch.bfloat16) run what a bare plan
    runs: the JAX package applies no plane dtype on the per-head path."""
    a = gat_csr(n=120, seed=17)
    _, (plan, _) = plan_pairs(a)
    p = vt.gat_flash_params_from_jax(params_np(10, 8, 4, heads=3, seed=18), device="cpu")
    x = torch.from_numpy(features(a.shape[0], 10, seed=19))
    with torch.no_grad():
        base = vt.gat_flash_forward(p, plan, x)
        for g in ((plan, None), (plan, None, torch.bfloat16), (plan, None, torch.float32)):
            before = single_calls()
            assert torch.equal(vt.gat_flash_forward(p, g, x), base)
            assert single_since(before) == (4, 0, 0)


@functools.cache
def bare_loss_problem():
    """tests/test_gat_flash.py:62-116's training problem on a bare plan:
    the JAX package's gat_flash_loss and gradients."""
    a = gat_csr(n=150, seed=20)
    jg, tg = plan_pairs(a)
    p = params_np(10, 8, 4, heads=2, seed=21)
    x = features(a.shape[0], 10, seed=22)
    y = np.random.default_rng(23).integers(0, 4, size=a.shape[0])
    loss, grads = jax.value_and_grad(jmodels.gat_flash_loss)(
        jnp_params(p), jg[0], jnp.asarray(x), jnp.asarray(y))
    return jg[0], tg[0], p, x, y, float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_bare_plan_loss_gradients_match_jax():
    """Per head K9 forward, K10 and the lane scatter backward, against
    jax.grad at tests/test_gat_flash.py:113-116's rtol 3e-3 / atol 3e-4."""
    _, tg, p, x, y, loss_j, grads_j = bare_loss_problem()
    pt = {k: v.requires_grad_(True)
          for k, v in vt.gat_flash_params_from_jax(p, device="cpu").items()}
    before = single_calls()
    loss = vt.gat_flash_loss(pt, tg, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert single_since(before) == (3, 3, 0)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), grads_j[k], rtol=3e-3, atol=3e-4,
                                   err_msg=k)


def test_bare_plan_sgd_step_matches_jax():
    """make_gat_flash_train_step on a bare plan: the JAX package's SGD step."""
    jplan, tplan, p, x, y, _, _ = bare_loss_problem()
    pj_new, loss_j = jmodels.make_gat_flash_train_step(lr=5e-2)(
        jnp_params(p), jplan, jnp.asarray(x), jnp.asarray(y))
    pt_new, loss = vt.make_gat_flash_train_step(lr=5e-2)(
        vt.gat_flash_params_from_jax(p, device="cpu"), tplan, torch.from_numpy(x),
        torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k, v in pt_new.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(pj_new[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("with_t", [False, True], ids=["lanes", "split"])
def test_flash_attention_aggregate_matches_jax(with_t):
    """One head through flash_attention_aggregate (slope 0.2 by default),
    with the transpose plan (K11 and K12) and without (K10): out and
    gradients against the JAX package's."""
    a = gat_csr(n=140, density=0.04, seed=24, directed=True)
    (jp, jpt), (tp, tpt) = plan_pairs(a, (32, 128))
    n = a.shape[0]
    q, k, v = (features(n, d, seed=25 + i) for i, d in enumerate((12, 12, 20)))
    w = features(n, 20, seed=28)

    def jloss(q_, k_, v_):
        out = jmodels.flash_attention_aggregate(jp, q_, k_, v_, plan_t=jpt if with_t else None)
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_aggregate(tp, *leaves, plan_t=tpt if with_t else None)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for leaf, ref, name in zip(leaves, grads, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-4,
                                   err_msg=f"d{name}")


def test_per_head_slice_matches_jax():
    """Path H of chip_smoke.py at a small size: a symmetric power-law
    graph with self-loops, a bare PlanConfig(128, 128, block_unroll=4)
    plan, 2 heads; three requests (K9 3 each; the first held against JAX),
    then one Adam step (K9 3, K10 3) whose gradients match jax.grad at
    tests/test_gat_flash.py:113-116's tolerance."""
    a = symmetrize(chung_lu_csr(300, 1200, seed=29))
    a = ((a + sp.eye(a.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    n = a.shape[0]
    (jplan, _), (tplan, _) = plan_pairs(a, (128, 128), unroll=4)
    p = params_np(16, 8, 6, heads=2, seed=30)
    model = vt.GATFlash.from_params(vt.gat_flash_params_from_jax(p, device="cpu"))
    for request in range(3):
        x = features(n, 16, seed=31 + request)
        before = single_calls()
        with torch.no_grad():
            out = model(tplan, torch.from_numpy(x))
        assert single_since(before) == (3, 0, 0)
        if request == 0:
            ref = jmodels.gat_flash_forward(jnp_params(p), jplan, jnp.asarray(x))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    y = np.random.default_rng(34).integers(0, 6, size=n)
    grads_j = jax.grad(jmodels.gat_flash_loss)(jnp_params(p), jplan, jnp.asarray(x),
                                               jnp.asarray(y))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_flash_loss)
    before = single_calls()
    step(model.params(), tplan, torch.from_numpy(x), torch.from_numpy(y))
    assert single_since(before) == (3, 3, 0)
    for k, v in model.params().items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads_j[k]), rtol=3e-3,
                                   atol=3e-4, err_msg=k)


def test_model_shares_gat_dot_parameters():
    model = vt.GATFlash(20, 8, 5, num_heads=3, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    dot = vt.GATDot(20, 8, 5, num_heads=3, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert isinstance(model, vt.GATDot)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), dot.parameters()))
    assert vt.gat_flash_params_from_jax is vt.gat_dot_params_from_jax
    assert inspect.signature(vt.GATFlash).parameters["device"].default == "cuda"


def test_flash_gat_slice_matches_jax():
    """Path G of chip_smoke.py at a small size: a symmetric power-law graph
    with self-loops, PlanConfig(128, 128, block_unroll=4), 2 heads, bf16
    planes named in the tuple as the full size picks them; three requests
    (K13 twice each; the first held against JAX), then one Adam step
    (K13, K14 and K15 twice each) whose gradients match jax.grad, to
    BF16_MODEL_TOL (logits) and max error over max magnitude < 1e-2
    (gradients) for BF16_MODEL_TOL's reason."""
    a = symmetrize(chung_lu_csr(300, 1200, seed=17))
    a = ((a + sp.eye(a.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    n = a.shape[0]
    jg, tg = plan_pairs(a, (128, 128), unroll=4)
    jg, tg = (*jg, jnp.bfloat16), (*tg, torch.bfloat16)
    p = params_np(16, 8, 6, heads=2, seed=18)
    model = vt.GATFlash.from_params(vt.gat_flash_params_from_jax(p, device="cpu"))
    for request in range(3):
        x = features(n, 16, seed=20 + request)
        before = calls()
        with torch.no_grad():
            out = model(tg, torch.from_numpy(x))
        assert since(before) == (2, 0, 0)
        if request == 0:
            ref = jmodels.gat_flash_forward(jnp_params(p), jg, jnp.asarray(x))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BF16_MODEL_TOL)
    y = np.random.default_rng(19).integers(0, 6, size=n)
    grads_j = jax.grad(jmodels.gat_flash_loss)(jnp_params(p), jg, jnp.asarray(x), jnp.asarray(y))
    step = make_train_step(torch.optim.Adam(model.parameters(), lr=5e-3), vt.gat_flash_loss)
    before = calls()
    step(model.params(), tg, torch.from_numpy(x), torch.from_numpy(y))
    assert since(before) == (2, 2, 2)
    for k, v in model.params().items():
        ref = np.asarray(grads_j[k])
        assert np.abs(v.grad.numpy() - ref).max() / np.abs(ref).max() < 1e-2, k

"""Parity of the PyTorch port's GCN serving path with the JAX package on
the CPU: the same graph, parameters and features give the same logits.

The port aggregates through kernel K1's plain version on a CPU tensor;
the JAX side runs `spmm_pallas` in interpret mode. Logits are compared at
rtol 1e-4, atol 1e-4: two float32 aggregations and two dense products
summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, erdos_renyi_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch.models.graph import aggregate
from voltrix_spmm_tpu_torch.ops import spmm_reference

TOL = dict(rtol=1e-4, atol=1e-4)


def power_law_graph(n=1500, edges=6000, seed=0):
    """A small symmetric Chung-Lu graph: the degree family of the
    ogbn-arxiv proxy the slice serves, hub rows included."""
    return symmetrize(chung_lu_csr(n, edges, seed=seed))


def both_graphs(a, block_h=128, symmetric=None):
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(block_h, 128),
                             symmetric=symmetric, backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(block_h, 128),
                        symmetric=symmetric, device="cpu")
    return gj, gt


def jax_params(in_dim, hidden, classes, seed=0):
    """`init_gcn` parameters as numpy, with nonzero biases so both bias
    additions are checked."""
    p = {k: np.asarray(v) for k, v in
         jmodels.init_gcn(jax.random.PRNGKey(seed), in_dim, hidden, classes).items()}
    rng = np.random.default_rng(seed)
    p["b1"] = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    p["b2"] = (0.1 * rng.standard_normal(classes)).astype(np.float32)
    return p


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("in_dim,transform_first", [
    (64, "auto"),    # in_dim <= 256: aggregate, then transform
    (300, "auto"),   # in_dim > 256 and a narrower hidden: transform first
    (64, True),
    (300, False),
])
def test_gcn_forward_matches_jax(in_dim, transform_first):
    a = power_law_graph()
    n = a.shape[0]
    gj, gt = both_graphs(a)
    p = jax_params(in_dim, 32, 8)
    x = features(n, in_dim, seed=1)
    ref = jmodels.gcn_forward({k: jnp.asarray(v) for k, v in p.items()}, gj, jnp.asarray(x),
                              transform_first=transform_first)
    out = vt.gcn_forward(vt.gcn_params_from_jax(p, device="cpu"), gt, torch.from_numpy(x),
                         transform_first=transform_first)
    assert out.shape == (n, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gcn_params_from_jax():
    p = jmodels.init_gcn(jax.random.PRNGKey(3), 20, 16, 5)
    t = vt.gcn_params_from_jax(p, device="cpu")
    assert set(t) == {"w1", "b1", "w2", "b2"}
    for k, v in t.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(p[k]))  # (in, out) layout kept


def test_gcn_module_runs_gcn_forward():
    a = power_law_graph(n=600, edges=2000, seed=2)
    n = a.shape[0]
    _, gt = both_graphs(a)
    p = vt.gcn_params_from_jax(jax_params(48, 16, 4, seed=2), device="cpu")
    model = vt.GCN.from_params(p)
    assert [name for name, _ in model.named_parameters()] == ["w1", "b1", "w2", "b2"]
    x = torch.from_numpy(features(n, 48, seed=3))
    with torch.no_grad():
        assert torch.equal(model(gt, x), vt.gcn_forward(p, gt, x))


def test_gcn_init_from_generator():
    def make(seed):
        return vt.GCN(300, 64, 10, generator=torch.Generator().manual_seed(seed), device="cpu")

    m1, m2, m3 = make(0), make(0), make(1)
    assert torch.equal(m1.w1, m2.w1) and torch.equal(m1.w2, m2.w2)
    assert not torch.equal(m1.w1, m3.w1)
    assert tuple(m1.w1.shape) == (300, 64) and tuple(m1.w2.shape) == (64, 10)
    assert not m1.b1.any() and not m1.b2.any()
    # He normal, as init_gcn: std sqrt(2 / fan_in)
    assert abs(m1.w1.std().item() / (2 / 300) ** 0.5 - 1) < 0.05


def test_build_graph_matches_jax():
    n = 800
    a = erdos_renyi_csr(n, 0.01, seed=4)
    gj, gt = both_graphs(a, block_h=64)
    assert gt.plan_t is not gt.plan  # asymmetric: a transpose plan of its own
    for plan_t, jplan_t in ((gt.plan_t, gj.plan_t), (gt.plan, gj.plan)):
        np.testing.assert_array_equal(plan_t.bitmask.numpy().view(np.uint32),
                                      np.asarray(jplan_t.bitmask))
        np.testing.assert_array_equal(plan_t.hind.numpy(), np.asarray(jplan_t.hind))
        np.testing.assert_array_equal(plan_t.block_ptr.numpy(), np.asarray(jplan_t.block_ptr))
    np.testing.assert_array_equal(gt.inv_deg.numpy(), np.asarray(gj.inv_deg))
    np.testing.assert_array_equal(gt.inv_sqrt_deg.numpy(), np.asarray(gj.inv_sqrt_deg))
    assert gt.num_nodes == gj.num_nodes == n

    s = symmetrize(a)
    gj, gt = both_graphs(s, block_h=64)
    assert gt.plan_t is gt.plan and gj.plan_t is gj.plan  # detected as symmetric


def test_build_graph_default_config_matches_jax():
    """The JAX call form build_graph(indptr, indices, n, symmetric=True)
    (examples/train_linkpred.py:48): both default to PlanConfig() and
    build the same plans, bit for bit."""
    a = power_law_graph(n=700, edges=2500, seed=7)
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, symmetric=True)
    gt = vt.build_graph(a.indptr, a.indices, n, symmetric=True, device="cpu")
    assert gt.plan.config == vt.PlanConfig() and gt.plan_t is gt.plan
    np.testing.assert_array_equal(gt.plan.bitmask.numpy().view(np.uint32),
                                  np.asarray(gj.plan.bitmask))
    for name in ("hind", "window_of_block", "block_ptr"):
        np.testing.assert_array_equal(getattr(gt.plan, name).numpy(),
                                      np.asarray(getattr(gj.plan, name)), err_msg=name)
    np.testing.assert_array_equal(gt.inv_deg.numpy(), np.asarray(gj.inv_deg))


def test_build_graph_moves_the_plan_once():
    a = power_law_graph(n=400, edges=1500, seed=5)
    g = vt.build_graph(a.indptr, a.indices, a.shape[0], vt.PlanConfig(128, 128),
                       symmetric=True, device="meta")
    assert g.plan_t is g.plan
    for name in ("bitmask", "hind", "window_of_block", "block_ptr"):
        assert getattr(g.plan, name).device.type == "meta", name
    assert g.inv_deg.device.type == "meta" and g.inv_sqrt_deg.device.type == "meta"


@pytest.mark.parametrize("kwargs", [dict(config="auto"), dict(stream_chunks=4)])
def test_build_graph_refuses_unported(kwargs):
    """config="auto" waits for the H100 tuner (item 9); stream_chunks builds
    window chunks, which aggregate exactly as the whole plan does."""
    a = power_law_graph(n=300, edges=900, seed=6)
    kwargs = {"config": vt.PlanConfig(32, 128), **kwargs}
    if "stream_chunks" not in kwargs:
        with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
            vt.build_graph(a.indptr, a.indices, a.shape[0], device="cpu", **kwargs)
        return
    n = a.shape[0]
    g = vt.build_graph(a.indptr, a.indices, n, device="cpu", **kwargs)
    assert isinstance(g.plan, list) and len(g.plan) == 4 and g.num_nodes == n
    whole = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(32, 128), device="cpu")
    x = torch.from_numpy(features(n, 16, seed=6))
    assert torch.equal(aggregate(g, x), aggregate(whole, x))


def test_serving_slice_matches_jax():
    """The slice as chip_smoke.py drives it, at a small size: a symmetric
    power-law graph, PlanConfig(128, 128), a GCN in -> hidden -> classes
    from seeded parameters, three requests through gcn_forward, and two
    aggregations per request."""
    a = power_law_graph(n=2048, edges=9000, seed=7)
    n = a.shape[0]
    in_dim, hidden, classes = 128, 64, 10
    gj, gt = both_graphs(a, symmetric=True)
    p = jax_params(in_dim, hidden, classes, seed=7)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    model = vt.GCN.from_params(vt.gcn_params_from_jax(p, device="cpu")).eval()
    for request in range(3):
        x = features(n, in_dim, seed=10 + request)
        calls = spmm_reference.calls
        with torch.no_grad():
            out = model(gt, torch.from_numpy(x))
        assert spmm_reference.calls == calls + 2
        assert out.shape == (n, classes) and bool(torch.isfinite(out).all())
        ref = np.asarray(jmodels.gcn_forward(pj, gj, jnp.asarray(x)))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_gcn_gradient_matches_jax():
    """Gradients through spmm_ad's backward (the transpose SpMM) reach
    every parameter as jax.grad has them, on an asymmetric graph."""
    n = 500
    a = erdos_renyi_csr(n, 0.02, seed=8)
    gj, gt = both_graphs(a, block_h=64)
    p = jax_params(40, 16, 6, seed=8)
    x = features(n, 40, seed=9)
    w = features(n, 6, seed=10)

    def jloss(params):
        return jnp.sum(jmodels.gcn_forward(params, gj, jnp.asarray(x)) * w)

    ref = jax.grad(jloss)({k: jnp.asarray(v) for k, v in p.items()})
    pt = {k: v.requires_grad_(True) for k, v in vt.gcn_params_from_jax(p, device="cpu").items()}
    (vt.gcn_forward(pt, gt, torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(ref[k]), **TOL, err_msg=k)

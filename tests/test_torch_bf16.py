"""Parity of the port's bfloat16 feature sources with the JAX package on
the CPU: `spmm` on bf16 rows for K1, K2, K3, the hybrid, window chunks,
ELL and (B, N, D) batches, `compute_dtype=bfloat16` on float32 rows,
`aggregate` under `GraphData.agg_dtype` in its three modes with
gradients, a 2-layer GCN's loss and gradients, `build_graph("auto")`'s
rule and an exported bf16 aggregate.

On a CPU tensor the port runs each kernel's plain version (the rows
widened exactly to float32, the sums float32); the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Tolerances:

- the default bf16 output is held within one bf16 ulp of JAX's: the two
  float32 sums may differ in their last bits, and one rounding to bf16 can
  then land on the neighbouring value;
- float32 outputs (out_dtype=float32, compute_dtype=bfloat16 on float32
  rows) at tests/test_spmm.py:32-33's float32 tolerance, rtol 1e-5, atol
  1e-4: the same bf16 values summed in float32 in another order;
- aggregations, GCN logits and gradients whose bf16 roundings sit between
  float32 steps at `BF16_TOL` (below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu as jvx
import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.format.stream import slice_plan_windows as jslice
from voltrix_spmm_tpu_torch.format.stream import slice_plan_windows
from voltrix_spmm_tpu_torch.models.graph import aggregate
from voltrix_spmm_tpu_torch.ops import spmm_reference, spmm_scipy

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:32-33
# a value rounded to bf16 on one side may land one bf16 ulp (2**-8
# relative) from the other side's, and a float32 step after it (a degree
# scale, a dense product) carries that relative step on
BF16_TOL = dict(rtol=2**-7, atol=1e-5)


def random_csr(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def f32(x):
    """A JAX or torch array, any float type, as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_within_one_ulp(out, ref):
    """Each bf16 value of `out` is `ref`'s or its bf16 neighbour."""
    out, ref = f32(out), f32(ref)
    assert out.shape == ref.shape
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert bool((np.abs(out - ref) <= ulp).all()), float(np.abs(out - ref).max())


def j16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def t16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def plans(a, cfg):
    n = a.shape[0]
    jplan = jvx.csr_preprocess(a.indptr, a.indices, n, JaxPlanConfig(**cfg), backend="numpy")
    return jplan, vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg))


def hybrid_plans(a):
    n = a.shape[0]
    kw = dict(threshold=8)
    jp = jfmt.csr_preprocess_hybrid(a.indptr, a.indices, n, backend="numpy",
                                    dense_config=JaxPlanConfig(32, 128, 16),
                                    sparse_config=JaxPlanConfig(32, 128, 1), **kw)
    tp = vt.csr_preprocess_hybrid(a.indptr, a.indices, n, dense_config=vt.PlanConfig(32, 128, 16),
                                  sparse_config=vt.PlanConfig(32, 128, 1), **kw)
    return jp, tp


def ell_plans(a, seed):
    n = a.shape[0]
    vals = np.random.default_rng(seed).standard_normal(a.nnz).astype(np.float32)
    cfg = dict(block_h=32, block_w=128, block_unroll=4)
    jp = jfmt.csr_preprocess_ell(a.indptr, a.indices, n, JaxPlanConfig(**cfg), values=vals)
    tp = vt.csr_preprocess_ell(a.indptr, a.indices, n, vt.PlanConfig(**cfg), values=vals)
    return jp, tp


# (label, the two plans from a csr, spmm keyword arguments): K1 on two
# geometries, K2 on a clustered plan, K3 at seg 8 and 16, the hybrid (K3 +
# K1), window chunks, ELL (K6)
def _cases():
    return [
        ("K1 h32", lambda a: plans(a, dict(block_h=32, block_w=128)), {}),
        ("K1 h128", lambda a: plans(a, dict(block_h=128, block_w=128)), {}),
        ("K2 clustered", lambda a: plans(a, dict(block_h=256, block_w=128, block_unroll=2,
                                                 cluster_cols=True)), dict(subtile=True)),
        ("K3 seg 8", lambda a: plans(a, dict(block_h=128, block_w=128, gather_segment=8)), {}),
        ("K3 seg 16", lambda a: plans(a, dict(block_h=32, block_w=128, gather_segment=16)), {}),
        ("hybrid", hybrid_plans, {}),
        ("window chunks", lambda a: tuple(
            (jslice(j, 3), slice_plan_windows(t, 3))
            for j, t in [plans(a, dict(block_h=32, block_w=128))])[0], {}),
        ("ELL", lambda a: ell_plans(a, seed=4), {}),
    ]


CASES = _cases()


def _jax_spmm(jplan, x, **kw):
    """The JAX package's spmm with the Pallas kernels in interpret mode."""
    if isinstance(jplan, jfmt.ell.EllPlan):
        return jops.spmm_ell(jplan, x, interpret=True, **kw)
    if isinstance(jplan, list):
        return jvx.spmm(jplan, x, interpret=True, **kw)
    return jvx.spmm(jplan, x, interpret=True, **kw)


@pytest.mark.parametrize("label,make,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("n,d", [(512, 128), (300, 130)])
def test_spmm_on_bf16_rows_matches_jax(label, make, kw, n, d):
    """Default output bf16 within one bf16 ulp of JAX's; out_dtype=float32
    at the float32 tolerance."""
    a = random_csr(n, 0.05, seed=n + d)
    jplan, tplan = make(a)
    x = features(n, d, seed=d)
    jkw = {"subtile": True} if kw.get("subtile") else {}
    out = vt.spmm(tplan, t16(x), **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (n, d)
    # the hybrid: JAX rounds each side to bf16 and adds the two in bf16, where
    # the port sums the sides in float32 and rounds once; a side's rounding
    # is relative to the side, not to the sum, so there the port is held to
    # JAX's float32 sum rounded once (below)
    if label != "hybrid":
        assert_within_one_ulp(out, _jax_spmm(jplan, j16(x), **jkw))
    out32 = vt.spmm(tplan, t16(x), out_dtype=torch.float32, **kw)
    assert out32.dtype == torch.float32
    want32 = _jax_spmm(jplan, j16(x), out_dtype=jnp.float32, **jkw)
    np.testing.assert_allclose(f32(out32), f32(want32), **TOL)
    assert_within_one_ulp(out, want32)  # one rounding of the float32 sums
    # the plain path sums the widened rows: the float32 SpMM of them
    want = vt.spmm(tplan, t16(x).float(), **kw)
    assert torch.equal(out32, want)


COMPUTE_CASES = [c for c in CASES if c[0] in ("K1 h128", "K3 seg 8", "hybrid", "window chunks",
                                              "ELL")]


@pytest.mark.parametrize("label,make,kw", COMPUTE_CASES, ids=[c[0] for c in COMPUTE_CASES])
def test_compute_dtype_bf16_matches_jax(label, make, kw):
    """compute_dtype=bfloat16 on float32 rows: the rows (and K6's edge
    values) rounded to bf16, float32 sums, a float32 result."""
    n, d = 400, 64
    a = random_csr(n, 0.05, seed=21)
    jplan, tplan = make(a)
    x = features(n, d, seed=22)
    out = vt.spmm(tplan, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    want = _jax_spmm(jplan, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(f32(out), f32(want), **TOL)
    # the same as the bf16 source on the rounded rows, returned in float32
    if label != "ELL":
        assert torch.equal(out, vt.spmm(tplan, t16(x), out_dtype=torch.float32))


def test_compute_dtype_rounds_ell_values():
    """K6 under compute_dtype=bfloat16 rounds its edge values too, as the
    JAX kernel casts them (ell.py:56-59), on the plain path and on
    impl="reference" alike."""
    a = random_csr(256, 0.05, seed=23)
    _, tplan = ell_plans(a, seed=24)
    x = torch.from_numpy(features(256, 16, seed=25))
    rounded = dataclasses.replace(tplan, vals=tplan.vals.to(torch.bfloat16).float())
    want = vt.spmm(rounded, x.to(torch.bfloat16).float())
    for impl in ("auto", "ell", "reference"):
        got = vt.spmm(tplan, x, impl=impl, compute_dtype=torch.bfloat16)
        assert got.dtype == torch.float32 and torch.equal(got, want), impl
    assert not torch.equal(vt.spmm(tplan, x.to(torch.bfloat16).float()), want)


def test_batched_bf16_features_match_jax():
    """(B, N, D) bf16 features fold into the feature axis, as JAX folds them."""
    n, b, d = 300, 3, 24
    a = random_csr(n, 0.05, seed=26)
    jplan, tplan = plans(a, dict(block_h=32, block_w=128))
    x = np.random.default_rng(27).standard_normal((b, n, d)).astype(np.float32)
    out = vt.spmm(tplan, t16(x))
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, d)
    assert_within_one_ulp(out, jvx.spmm(jplan, j16(x), interpret=True))
    out32 = vt.spmm(tplan, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(
        f32(out32), f32(jvx.spmm(jplan, jnp.asarray(x), compute_dtype=jnp.bfloat16,
                                 interpret=True)), **TOL)


@pytest.mark.parametrize("impl", ["pregather", "fused", "ell", "hybrid"])
def test_spmm_out_dtype_skips_bf16_roundtrip(impl):
    """The port's mirror of tests/test_spmm.py:225-266: the float32 result
    from bf16 rows is at least as close to the float64 product as the
    bf16-truncated one, and within bf16's accuracy class."""
    n, d = 512, 128
    rng = np.random.default_rng(0)
    a = sp.random(n, n, density=0.05, format="csr", random_state=rng)
    a.data[:] = 1.0
    feat = rng.standard_normal((n, d)).astype(np.float32)
    oracle = spmm_scipy(a.indptr, a.indices, n, feat).astype(np.float32)
    if impl == "ell":
        plan = vt.csr_preprocess_ell(a.indptr, a.indices, n, vt.PlanConfig(32, 128))
    elif impl == "hybrid":
        plan = hybrid_plans(a)[1]
    else:
        cfg = vt.PlanConfig(32, 128) if impl == "pregather" else vt.PlanConfig(128, 128, 8)
        plan = vt.csr_preprocess(a.indptr, a.indices, n, cfg)
    x16 = t16(feat)
    out = f32(vt.spmm(plan, x16, out_dtype=torch.float32))
    truncated = f32(vt.spmm(plan, x16))
    err_direct = float(np.abs(out - oracle).max())
    err_trunc = float(np.abs(truncated - oracle).max())
    assert err_direct <= err_trunc + 1e-6, (err_direct, err_trunc)
    assert vt.calc_diff(out, oracle) < 1e-2


def test_other_float_dtypes_keep_their_behaviour():
    """float16 and float64 features on the CPU run the plain path as before
    (the rows widened to float32, the output in their dtype);
    compute_dtype=float16 now runs (tests/test_torch_f16.py holds it to
    JAX) and equals the plain path on the rounded rows; int8 under either
    16-bit compute_dtype is still refused."""
    a = random_csr(256, 0.05, seed=28)
    _, tplan = plans(a, dict(block_h=32, block_w=128))
    x = torch.from_numpy(features(256, 8, seed=29))
    for dtype in (torch.float16, torch.float64):
        out = vt.spmm(tplan, x.to(dtype))
        assert out.dtype == dtype
        assert torch.equal(out, spmm_reference(tplan, x.to(dtype)))
    out = vt.spmm(tplan, x, compute_dtype=torch.float16)
    assert out.dtype == torch.float32
    assert torch.equal(out, spmm_reference(tplan, x.to(torch.float16), torch.float32))
    for compute in (torch.bfloat16, torch.float16):
        with pytest.raises(NotImplementedError, match="int8"):
            vt.spmm(tplan, x, impl="int8", compute_dtype=compute)


# --- aggregate, GCN, build_graph("auto"), export ---------------------------

def power_law_graph(n, edges, seed):
    return symmetrize(chung_lu_csr(n, edges, seed=seed))


def both_graphs(a, cfg=(128, 128), symmetric=None):
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(*cfg), symmetric=symmetric,
                             backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(*cfg), symmetric=symmetric,
                        device="cpu")
    return (dataclasses.replace(gj, agg_dtype=jnp.bfloat16),
            dataclasses.replace(gt, agg_dtype=torch.bfloat16))


@pytest.mark.parametrize("mode", ["sum", "mean", "sym"])
@pytest.mark.parametrize("cfg,symmetric", [((128, 128), True), ((64, 128), False),
                                           ((128, 128, 8), True)])
def test_aggregate_agg_dtype_matches_jax(mode, cfg, symmetric):
    """aggregate with agg_dtype=bfloat16: the output in x's dtype (float32),
    and the gradient in x by jax.grad against torch.autograd, both through
    the bf16 SpMM and its bf16 cotangent."""
    n, d = 700, 24
    a = power_law_graph(n, 3000, seed=30) if symmetric else random_csr(n, 0.01, seed=30)
    gj, gt = both_graphs(a, cfg, symmetric=symmetric)
    x = features(n, d, seed=31)
    w = features(n, d, seed=32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = aggregate(gt, xt, mode=mode)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    want = jmodels.aggregate(gj, jnp.asarray(x), mode=mode)
    np.testing.assert_allclose(f32(out), f32(want), **BF16_TOL)
    jgrad = jax.grad(lambda v: jnp.sum(jmodels.aggregate(gj, v, mode=mode) * w))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), f32(jgrad), **BF16_TOL)
    # the bf16 path is its own: the float32 aggregation differs
    plain = aggregate(dataclasses.replace(gt, agg_dtype=None), torch.from_numpy(x), mode=mode)
    assert not torch.equal(out.detach(), plain)


def test_gcn_with_agg_dtype_matches_jax():
    """A 2-layer GCN on a bf16 aggregation: loss and gradients against
    jax.grad of JAX's gcn_forward on the same graph and parameters."""
    n, in_dim, hidden, classes = 800, 32, 16, 5
    a = power_law_graph(n, 3500, seed=33)
    gj, gt = both_graphs(a)
    rng = np.random.default_rng(34)
    p = {"w1": rng.standard_normal((in_dim, hidden)) * 0.3, "b1": rng.standard_normal(hidden) * 0.1,
         "w2": rng.standard_normal((hidden, classes)) * 0.3, "b2": rng.standard_normal(classes) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = features(n, in_dim, seed=35)
    labels = rng.integers(0, classes, n)

    def jloss(params):
        logits = jmodels.gcn_forward(params, gj, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1))

    jl, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in p.items()})
    pt = {k: v.requires_grad_(True) for k, v in vt.gcn_params_from_jax(p, device="cpu").items()}
    loss = vt.gcn_loss(pt, gt, torch.from_numpy(x), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), f32(jg[k]), rtol=2**-7,
                                   atol=2**-7 * float(np.abs(f32(jg[k])).max()), err_msg=k)
    logits = vt.gcn_forward(pt, gt, torch.from_numpy(x)).detach()
    host = jmodels.gcn_forward({k: jnp.asarray(v) for k, v in p.items()},
                               dataclasses.replace(gj, agg_dtype=None), jnp.asarray(x))
    assert vt.calc_diff(f32(logits), f32(host)) < 1e-2  # bf16's class


def test_auto_rule_as_decided_on_the_card():
    """build_graph("auto")'s agg_dtype, as the card decided it (PERF.md
    section 6: K1's bf16 rows ran 1.24x / 1.25x float32's on A): the port
    keeps float32 (agg_dtype None) where the JAX rule (no gather runs, at
    least 65,536 rows) streams bf16, and both keep it on a small graph."""
    n = 65536
    a = symmetrize(chung_lu_csr(n, 2 * n, seed=36))
    gj = jmodels.build_graph(a.indptr, a.indices, n, config="auto", backend="numpy")
    assert gj.agg_dtype == jnp.bfloat16 and gj.plan.config.gather_segment == 1
    gt = vt.build_graph(a.indptr, a.indices, n, config="auto", device="cpu")
    assert gt.plan.config.gather_segment == 1
    assert gt.agg_dtype is None
    small = power_law_graph(300, 900, seed=37)
    assert jmodels.build_graph(small.indptr, small.indices, 300, config="auto",
                               backend="numpy").agg_dtype is None
    assert vt.build_graph(small.indptr, small.indices, 300, config="auto",
                          device="cpu").agg_dtype is None


def test_exported_bf16_aggregate_matches_eager():
    """An aggregate under agg_dtype=bfloat16 exports through the registered
    ops unchanged; the loaded program gives the eager path's bits."""
    from voltrix_spmm_tpu_torch.serve import export_servable, load_servable

    a = power_law_graph(500, 2000, seed=40)
    _, gt = both_graphs(a)
    x = torch.from_numpy(features(a.shape[0], 16, seed=41))

    def fn(v):
        return aggregate(gt, v, mode="mean")

    served = load_servable(export_servable(fn, x))
    calls = spmm_reference.calls
    out = served(x)
    assert spmm_reference.calls == calls + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, fn(x))

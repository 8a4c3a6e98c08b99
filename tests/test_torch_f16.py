"""Parity of the port's float16 (IEEE half) feature sources with the JAX
package on the CPU: `spmm` on float16 rows for K1, K2, K3, the hybrid,
window chunks, ELL and (B, N, D) batches, `compute_dtype=float16` on
float32 rows (K6 with edge values that round to float16 subnormals), a row
whose sum passes float16's range, `aggregate` under
`GraphData.agg_dtype=torch.float16` in its three modes with gradients, a
2-layer GCN's loss and gradients, an exported float16 aggregate and the
tuner's float16 `Variant` fields.

On a CPU tensor the port runs each kernel's plain version (the rows
widened exactly to float32, the sums float32); the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Tolerances:

- the default float16 output is the port's float32 sums rounded once, and
  within one float16 ulp of JAX's plus the distance of the two packages'
  float32 sums (held to the float32 tolerance below): one rounding each of
  sums that differ in their last bits can land on neighbouring values, and
  where a row's terms cancel, the sums' distance can pass a float16 ulp of
  the small result;
- float32 outputs (out_dtype=float32, compute_dtype=float16 on float32
  rows) at tests/test_spmm.py:32-33's float32 tolerance, rtol 1e-5, atol
  1e-4: the same float16 values summed in float32 in another order;
- aggregations, GCN logits and gradients whose float16 roundings sit
  between float32 steps at `F16_TOL`, derived as
  tests/test_torch_bf16.py:44-47 derives `BF16_TOL`: a value rounded to
  float16 on one side may land one float16 ulp (2**-11 relative, where
  bf16's is 2**-8) from the other side's, and a float32 step after it
  carries that relative step on, so rtol is two ulps, 2**-10 (bf16:
  2**-7), with bf16's atol 1e-5 for values near zero.
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
import voltrix_spmm_tpu.tuner.tuner as jtuner
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.format.stream import slice_plan_windows as jslice
from voltrix_spmm_tpu_torch.format.stream import slice_plan_windows
from voltrix_spmm_tpu_torch.models.graph import aggregate
from voltrix_spmm_tpu_torch.ops import spmm_reference
from voltrix_spmm_tpu_torch.tuner import Variant

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:32-33
F16_TOL = dict(rtol=2**-10, atol=1e-5)  # two float16 ulps (module docstring)
F16 = torch.float16


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


def assert_within_one_ulp(out, ref, sums, ref_sums):
    """Each float16 value of `out` (the rounding of float32 `sums`) lies
    within one float16 ulp of `ref`'s (the rounding of `ref_sums`) plus the
    sums' distance, |rnd(a) - rnd(b)| <= |a - b| + ulp / 2 + ulp / 2 (an ulp
    is 2**-10 of the value's binade, 2**-24 below the normal range)."""
    out, ref = f32(out), f32(ref)
    assert out.shape == ref.shape
    mag = np.maximum(np.abs(ref), np.float32(2.0**-14))
    ulp = np.exp2(np.floor(np.log2(mag)) - 10)
    slack = np.abs(f32(sums) - f32(ref_sums))
    assert bool((np.abs(out - ref) <= ulp + slack).all()), float(np.abs(out - ref).max())


def j16(x):
    return jnp.asarray(x).astype(jnp.float16)


def t16(x):
    return torch.from_numpy(x).to(F16)


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


def ell_plans(a, seed, vals=None):
    n = a.shape[0]
    if vals is None:
        vals = np.random.default_rng(seed).standard_normal(a.nnz).astype(np.float32)
    cfg = dict(block_h=32, block_w=128, block_unroll=4)
    jp = jfmt.csr_preprocess_ell(a.indptr, a.indices, n, JaxPlanConfig(**cfg), values=vals)
    tp = vt.csr_preprocess_ell(a.indptr, a.indices, n, vt.PlanConfig(**cfg), values=vals)
    return jp, tp


# (label, the two plans from a csr, spmm keyword arguments): K1 on two
# geometries, K2 on a clustered plan, K3 at seg 8 and 16, the hybrid (K3 +
# K1), window chunks, ELL (K6)
CASES = [
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


def _jax_spmm(jplan, x, **kw):
    """The JAX package's spmm with the Pallas kernels in interpret mode."""
    if isinstance(jplan, jfmt.ell.EllPlan):
        return jops.spmm_ell(jplan, x, interpret=True, **kw)
    return jvx.spmm(jplan, x, interpret=True, **kw)


@pytest.mark.parametrize("label,make,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("n,d", [(256, 64), (300, 130)])
def test_spmm_on_f16_rows_matches_jax(label, make, kw, n, d):
    """Default output float16 within one float16 ulp of JAX's;
    out_dtype=float32 at the float32 tolerance and bit for bit the float32
    SpMM of the widened rows."""
    a = random_csr(n, 0.05, seed=n + d + 1)
    jplan, tplan = make(a)
    x = features(n, d, seed=d + 1)
    jkw = {"subtile": True} if kw.get("subtile") else {}
    out = vt.spmm(tplan, t16(x), **kw)
    assert out.dtype == F16 and out.shape == (n, d)
    out32 = vt.spmm(tplan, t16(x), out_dtype=torch.float32, **kw)
    assert out32.dtype == torch.float32
    want32 = _jax_spmm(jplan, j16(x), out_dtype=jnp.float32, **jkw)
    np.testing.assert_allclose(f32(out32), f32(want32), **TOL)
    assert torch.equal(out, out32.to(F16))  # one rounding of the float32 sums
    # the hybrid: JAX rounds each side to float16 and adds the two in
    # float16, where the port sums the sides in float32 and rounds once, so
    # there the port is held to JAX's float32 sum rounded once
    want = want32.astype(jnp.float16) if label == "hybrid" else _jax_spmm(jplan, j16(x), **jkw)
    assert_within_one_ulp(out, want, out32, want32)
    assert torch.equal(out32, vt.spmm(tplan, t16(x).float(), **kw))


COMPUTE_CASES = [c for c in CASES if c[0] in ("K1 h128", "K2 clustered", "K3 seg 8", "hybrid",
                                              "window chunks", "ELL")]


@pytest.mark.parametrize("label,make,kw", COMPUTE_CASES, ids=[c[0] for c in COMPUTE_CASES])
def test_compute_dtype_f16_matches_jax(label, make, kw):
    """compute_dtype=float16 on float32 rows: the rows (and K6's edge
    values) rounded to float16, float32 sums, a float32 result."""
    n, d = 400, 64
    a = random_csr(n, 0.05, seed=121)
    jplan, tplan = make(a)
    x = features(n, d, seed=122)
    jkw = {"subtile": True} if kw.get("subtile") else {}
    out = vt.spmm(tplan, torch.from_numpy(x), compute_dtype=F16, **kw)
    assert out.dtype == torch.float32
    want = _jax_spmm(jplan, jnp.asarray(x), compute_dtype=jnp.float16, **jkw)
    np.testing.assert_allclose(f32(out), f32(want), **TOL)
    # the same as the float16 source on the rounded rows, returned in float32
    if label != "ELL":
        assert torch.equal(out, vt.spmm(tplan, t16(x), out_dtype=torch.float32, **kw))


def test_compute_dtype_rounds_ell_values_to_f16_subnormals():
    """K6 under compute_dtype=float16 rounds its edge values to float16, as
    the JAX kernel casts them (ell.py:56-59): values near 1e-6 become
    float16 subnormals (steps of 2**-24), kept, not flushed to zero; the
    plain path and impl="reference" alike, against JAX."""
    n, d = 256, 16
    a = random_csr(n, 0.05, seed=123)
    rng = np.random.default_rng(124)
    vals = (rng.uniform(0.5, 2.0, a.nnz) * 1e-6 * rng.choice([-1, 1], a.nnz)).astype(np.float32)
    jp, tplan = ell_plans(a, seed=124, vals=vals)
    rounded = tplan.vals.to(F16)
    real = tplan.vals != 0
    assert bool((rounded[real].abs() < 2.0**-14).all())  # subnormal float16
    assert bool((rounded[real] != 0).all())  # and kept
    x = features(n, d, seed=125) * 1e4  # the products stay in float32's normal range
    xt = torch.from_numpy(x)
    want = vt.spmm(dataclasses.replace(tplan, vals=rounded.float()), xt.to(F16).float())
    for impl in ("auto", "ell", "reference"):
        got = vt.spmm(tplan, xt, impl=impl, compute_dtype=F16)
        assert got.dtype == torch.float32 and torch.equal(got, want), impl
    assert not torch.equal(vt.spmm(tplan, xt.to(F16).float()), want)
    jwant = jops.spmm_ell(jp, jnp.asarray(x), compute_dtype=jnp.float16, interpret=True)
    np.testing.assert_allclose(f32(want), f32(jwant), **TOL)


def test_batched_f16_features_match_jax():
    """(B, N, D) float16 features fold into the feature axis, as JAX folds
    them; compute_dtype=float16 on a float32 batch."""
    n, b, d = 300, 3, 24
    a = random_csr(n, 0.05, seed=126)
    jplan, tplan = plans(a, dict(block_h=32, block_w=128))
    x = np.random.default_rng(127).standard_normal((b, n, d)).astype(np.float32)
    out = vt.spmm(tplan, t16(x))
    assert out.dtype == F16 and out.shape == (b, n, d)
    assert_within_one_ulp(out, jvx.spmm(jplan, j16(x), interpret=True),
                          vt.spmm(tplan, t16(x), out_dtype=torch.float32),
                          jvx.spmm(jplan, j16(x), out_dtype=jnp.float32, interpret=True))
    out32 = vt.spmm(tplan, torch.from_numpy(x), compute_dtype=F16)
    np.testing.assert_allclose(
        f32(out32), f32(jvx.spmm(jplan, jnp.asarray(x), compute_dtype=jnp.float16,
                                 interpret=True)), **TOL)


@pytest.mark.parametrize("label,make,kw", [c for c in CASES if c[0] in ("K1 h32", "K3 seg 8",
                                                                         "ELL")],
                         ids=["K1", "K3", "ELL"])
def test_sum_past_f16_range_is_inf(label, make, kw):
    """A row whose float32 sum passes 65,504 returns +-inf in float16 in both
    packages (one cast of the float32 sum, not a clamp); out_dtype=float32
    keeps the finite sum."""
    n, d = 256, 8
    a = random_csr(n, 0.05, seed=128).tolil()
    a[0, 1], a[0, 2] = 1.0, 1.0  # row 0 sums rows 1 and 2 among others
    a = a.tocsr()
    a.data[:] = 1.0
    jplan, tplan = make(a)
    x = np.zeros((n, d), np.float32)
    x[1:3, 0], x[1:3, 1] = 40000.0, -40000.0  # each a float16; their sums are not
    if label == "ELL":
        jplan, tplan = ell_plans(a, seed=0, vals=np.ones(a.nnz, np.float32))
    out = vt.spmm(tplan, t16(x))
    want = _jax_spmm(jplan, j16(x))
    for got in (out, want):
        g = f32(got)
        assert g[0, 0] == np.inf and g[0, 1] == -np.inf, g[0, :2]
        assert np.isfinite(np.delete(g, 0, axis=0)).all()
    np.testing.assert_array_equal(f32(out), f32(want))
    out32 = vt.spmm(tplan, t16(x), out_dtype=torch.float32)
    assert out32[0, 0] == 80000.0 and out32[0, 1] == -80000.0


def test_refusals_name_what_is_left():
    """Float16 planes on the attention kernels are refused with the
    ROADMAP entry that holds them, float64 rows on K8 with the types it
    takes, and a compute_dtype that is neither float32 nor a 16-bit type
    is refused."""
    a = random_csr(256, 0.05, seed=129)
    _, tplan = plans(a, dict(block_h=32, block_w=128))
    x = torch.from_numpy(features(256, 8, seed=130))
    with pytest.raises(ValueError, match="ROADMAP.md item 9"):
        vt.spmm_attention_mh(tplan, *(x[None],) * 3, plane_dtype=F16)
    with pytest.raises(TypeError, match="float16"):
        vt.spmm(tplan, x.double(), impl="int8")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        vt.spmm(tplan, x, compute_dtype=torch.float64)


# --- aggregate, GCN, export, tuner ------------------------------------------

def power_law_graph(n, edges, seed):
    return symmetrize(chung_lu_csr(n, edges, seed=seed))


def both_graphs(a, cfg=(128, 128), symmetric=None):
    n = a.shape[0]
    gj = jmodels.build_graph(a.indptr, a.indices, n, JaxPlanConfig(*cfg), symmetric=symmetric,
                             backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(*cfg), symmetric=symmetric,
                        device="cpu")
    return (dataclasses.replace(gj, agg_dtype=jnp.float16),
            dataclasses.replace(gt, agg_dtype=F16))


# the three modes on K1; a directed graph's own transpose plan; K3's
# coverage plan (its interpret-mode JAX kernel is the slow one) in mean mode
@pytest.mark.parametrize("mode,cfg,symmetric", [
    ("sum", (128, 128), True), ("mean", (128, 128), True), ("sym", (128, 128), True),
    ("sum", (64, 128), False), ("sym", (64, 128), False), ("mean", (128, 128, 8), True)])
def test_aggregate_f16_agg_dtype_matches_jax(mode, cfg, symmetric):
    """aggregate with agg_dtype=float16: the output in x's dtype (float32),
    and the gradient in x by jax.grad against torch.autograd, both through
    the float16 SpMM and its float16 cotangent."""
    n, d = 500, 16
    a = power_law_graph(n, 2000, seed=131) if symmetric else random_csr(n, 0.012, seed=131)
    gj, gt = both_graphs(a, cfg, symmetric=symmetric)
    x = features(n, d, seed=132)
    w = features(n, d, seed=133)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = aggregate(gt, xt, mode=mode)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    want = jmodels.aggregate(gj, jnp.asarray(x), mode=mode)
    np.testing.assert_allclose(f32(out), f32(want), **F16_TOL)
    jgrad = jax.grad(lambda v: jnp.sum(jmodels.aggregate(gj, v, mode=mode) * w))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), f32(jgrad), **F16_TOL)
    # the float16 path is its own: the float32 aggregation differs
    plain = aggregate(dataclasses.replace(gt, agg_dtype=None), torch.from_numpy(x), mode=mode)
    assert not torch.equal(out.detach(), plain)


def test_gcn_with_f16_agg_dtype_matches_jax():
    """A 2-layer GCN on a float16 aggregation, the weights carried across by
    models/params.py: loss and gradients against jax.grad of JAX's
    gcn_forward on the same graph and parameters, at F16_TOL's two ulps."""
    n, in_dim, hidden, classes = 800, 32, 16, 5
    a = power_law_graph(n, 3500, seed=134)
    gj, gt = both_graphs(a)
    rng = np.random.default_rng(135)
    p = {"w1": rng.standard_normal((in_dim, hidden)) * 0.3, "b1": rng.standard_normal(hidden) * 0.1,
         "w2": rng.standard_normal((hidden, classes)) * 0.3, "b2": rng.standard_normal(classes) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = features(n, in_dim, seed=136)
    labels = rng.integers(0, classes, n)

    def jloss(params):
        logits = jmodels.gcn_forward(params, gj, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=1))

    jl, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in p.items()})
    pt = {k: v.requires_grad_(True) for k, v in vt.gcn_params_from_jax(p, device="cpu").items()}
    loss = vt.gcn_loss(pt, gt, torch.from_numpy(x), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=F16_TOL["rtol"])
    for k in pt:
        np.testing.assert_allclose(pt[k].grad.numpy(), f32(jg[k]), rtol=F16_TOL["rtol"],
                                   atol=F16_TOL["rtol"] * float(np.abs(f32(jg[k])).max()),
                                   err_msg=k)
    logits = vt.gcn_forward(pt, gt, torch.from_numpy(x)).detach()
    host = jmodels.gcn_forward({k: jnp.asarray(v) for k, v in p.items()},
                               dataclasses.replace(gj, agg_dtype=None), jnp.asarray(x))
    assert vt.calc_diff(f32(logits), f32(host)) < 1e-4  # float16's class


def test_exported_f16_aggregate_matches_eager():
    """An aggregate under agg_dtype=float16 exports through the registered
    ops unchanged; the loaded program gives the eager path's bits."""
    from voltrix_spmm_tpu_torch.serve import export_servable, load_servable

    a = power_law_graph(500, 2000, seed=137)
    _, gt = both_graphs(a)
    x = torch.from_numpy(features(a.shape[0], 16, seed=138))

    def fn(v):
        return aggregate(gt, v, mode="mean")

    served = load_servable(export_servable(fn, x))
    calls = spmm_reference.calls
    out = served(x)
    assert spmm_reference.calls == calls + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, fn(x))
    assert not torch.equal(out, aggregate(dataclasses.replace(gt, agg_dtype=None), x, mode="mean"))


F16_VARIANTS = [
    Variant("pregather", block_h=32, feat_dtype="float16"),
    Variant("pregather", block_h=256, block_unroll=2, subtile=True, compute_dtype="float16"),
    Variant("fused", block_h=32, gather_segment=8, compute_dtype="float16"),
    Variant("hybrid", block_h=32, gather_segment=8, feat_dtype="float16"),
    Variant("ell", block_h=32, block_unroll=4, stream_chunks=2, compute_dtype="float16"),
]


def test_variant_f16_fields_and_runs():
    """feat_dtype and compute_dtype take "float16" for K1, K2, K3 and K6,
    with the JAX package's key; K4 and K8 take float16 rows and refuse a
    float16 compute_dtype; each variant runs and returns the caller's
    float32, against JAX's _run_variant at the float32 tolerance."""
    from voltrix_spmm_tpu_torch.tuner.tuner import _run_variant, build_variant_plan

    n, d = 256, 32
    a = random_csr(n, 0.05, seed=139)
    x = features(n, d, seed=140)
    for v in F16_VARIANTS:
        assert v.half and not v.bf16
        fields = {k: getattr(v, k) for k in ("impl", "block_h", "gather_segment", "block_unroll",
                                             "subtile", "feat_dtype", "compute_dtype",
                                             "stream_chunks")}
        jv = jtuner.Variant(**fields)
        assert v.key() == jv.key()
        plan = build_variant_plan(v, a.indptr, a.indices, n, None, device="cpu")
        out = _run_variant(v, plan, torch.from_numpy(x))
        assert out.dtype == torch.float32
        jplan = jtuner.build_variant_plan(jv, a.indptr, a.indices, n, None)
        want = jtuner._run_variant(jv, jplan, jnp.asarray(x))
        np.testing.assert_allclose(f32(out), f32(want), **TOL, err_msg=v.key())
    assert "/xfloat16/" in Variant("pregather", feat_dtype="float16").key()
    for impl in ("int8", "weighted"):
        assert Variant(impl, feat_dtype="float16").half
        with pytest.raises(NotImplementedError, match="K4 and K8"):
            Variant(impl, compute_dtype="float16")

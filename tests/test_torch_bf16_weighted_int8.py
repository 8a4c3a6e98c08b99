"""bf16 rows on kernels K4 and K8 against the JAX package on the CPU.

The same numpy-seeded inputs, rounded to bfloat16, go through both
packages; the JAX side runs `spmm_pallas_weighted`, `spmm_weighted_ad` and
`spmm_pallas_int8` in interpret mode, the port its plain versions, which
widen the bf16 rows and plane exactly and sum in float32 as K4's and K8's
bf16 instantiations do on the card.

- K4 on bf16 rows, with float32 and bf16 value planes: with
  out_dtype=torch.float32 against JAX on the widened inputs at
  tests/test_spmm.py:32-33's float32 tolerance (float32 sums in another
  order), and the bf16 output within one bf16 ulp of JAX's.
- `spmm_weighted_ad`'s gradients against `jax.grad`: dfeat in bf16 within
  one ulp; dvalues within one ulp of JAX's, whose cotangent is float32 where
  the port's takes the plane's dtype (pinned; ROADMAP.md §3).
- DropEdge on bf16 rows against JAX's arithmetic on the same keep mask.
- `quantize_rows` on bf16 rows: bit for bit JAX's (in bf16), and not the
  codes of the widened rows; `spmm(impl="int8")` on bf16 rows within one
  bf16 ulp of `spmm_pallas_int8`.
- The tuner's bf16 K4 and K8 variants run and return the caller's dtype,
  the float32 sums cast once, where JAX's round them through bf16 first
  (pinned; ROADMAP.md §3).
- torch.export of both calls gives the eager bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.tuner import tuner as jtuner
from voltrix_spmm_tpu_torch.models import dropedge_weights
from voltrix_spmm_tpu_torch.ops import spmm_int8, spmm_weighted, spmm_weighted_ad
from voltrix_spmm_tpu_torch.serve import export_servable, load_servable
from voltrix_spmm_tpu_torch.tuner import Variant
from voltrix_spmm_tpu_torch.tuner.tuner import _run_variant

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:32-33
N = 300
BF16 = torch.bfloat16


def bf16_np(x: np.ndarray) -> np.ndarray:
    """float32 numpy values rounded to bf16 (round to nearest even), as
    float32."""
    return torch.from_numpy(np.array(x, np.float32)).to(BF16).float().numpy()


def assert_within_ulp(got, want, ulps=1):
    """got and want (bf16 values, as float32 arrays) within `ulps` bf16
    ulps of the larger magnitude: float32 sums in another order may round
    to the neighbouring bf16 value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulps * ulp + 1e-30), np.abs(got - want).max()


def weighted_csr(seed, density=0.04):
    rng = np.random.default_rng(seed)
    a = sp.random(N, N, density=density, format="csr", random_state=rng)
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    a.sort_indices()
    return a


@pytest.fixture(scope="module")
def graph():
    """A weighted graph, its transpose with the transposed values, and both
    packages' plans of each at PlanConfig(32, 128) and (64, 128)."""
    a = weighted_csr(seed=1)
    at = a.T.tocsr()
    at.sort_indices()
    out = {"a": a}
    for h in (32, 64):
        for name, m in (("plan", a), ("plan_t", at)):
            out[(name, h, "jax")] = jfmt.csr_preprocess(
                m.indptr, m.indices, N, jfmt.PlanConfig(h, 128), backend="numpy",
                values=m.data.astype(np.float32))
            out[(name, h, "torch")] = vt.csr_preprocess(m.indptr, m.indices, N,
                                                        vt.PlanConfig(h, 128), values=m.data)
    return out


def with_plane(jplan, tplan, bf16_plane):
    """Both plans with the plane in bf16 (the same rounded values) or as
    built (float32)."""
    if not bf16_plane:
        return jplan, tplan
    plane = tplan.values.to(BF16)
    return (dataclasses.replace(jplan, values=jnp.asarray(plane.float().numpy(), jnp.bfloat16)),
            dataclasses.replace(tplan, values=plane))


# --- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("h,plane,d", [(32, "float32", 13), (32, "bfloat16", 13),
                                       (64, "bfloat16", 40), (64, "float32", 130),
                                       (64, "bfloat16", 8)])
def test_k4_bf16_rows_against_jax(graph, h, plane, d):
    jplan, tplan = with_plane(graph[("plan", h, "jax")], graph[("plan", h, "torch")],
                              plane == "bfloat16")
    xb = bf16_np(np.random.default_rng(d).standard_normal((N, d)).astype(np.float32))
    x16 = torch.from_numpy(xb).to(BF16)
    # JAX on the widened rows and plane: K4's float32 sums
    jplan32 = dataclasses.replace(jplan, values=jnp.asarray(jplan.values, jnp.float32))
    want32 = np.asarray(jops.spmm_pallas_weighted(jplan32, jnp.asarray(xb)))
    got32 = spmm_weighted(tplan, x16, out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    assert vt.calc_diff(got32.numpy(), want32) < 1e-6
    np.testing.assert_allclose(got32.numpy(), want32, **TOL)
    # JAX on the bf16 rows and plane: the bf16 output
    want16 = jops.spmm_pallas_weighted(jplan, jnp.asarray(xb, jnp.bfloat16))
    got16 = vt.spmm(tplan, x16)
    assert got16.dtype == BF16 and want16.dtype == jnp.bfloat16
    assert_within_ulp(got16.float().numpy(), np.asarray(want16.astype(jnp.float32)))
    assert torch.equal(got16, got32.to(BF16))


@pytest.mark.parametrize("plane", ["float32", "bfloat16"])
def test_weighted_ad_bf16_gradients_against_jax(graph, plane):
    """dfeat is K4 over the transpose plan on the cotangent in the features'
    dtype (JAX weighted.py:334-336), within one bf16 ulp; dvalues is K5 on
    widened operands. JAX returns dvalues in float32 for a bf16 plane; torch
    casts a gradient to its input's dtype, so the port's is bf16: pinned."""
    bf16_plane = plane == "bfloat16"
    jplan, tplan = with_plane(graph[("plan", 64, "jax")], graph[("plan", 64, "torch")],
                              bf16_plane)
    jplan_t, tplan_t = with_plane(graph[("plan_t", 64, "jax")], graph[("plan_t", 64, "torch")],
                                  bf16_plane)
    rng = np.random.default_rng(7)
    xb = bf16_np(rng.standard_normal((N, 24)).astype(np.float32))
    g = rng.standard_normal((N, 24)).astype(np.float32)

    def jloss(values, feat):
        out = jops.spmm_weighted_ad(dataclasses.replace(jplan, values=values), jplan_t, feat)
        return jnp.sum(out.astype(jnp.float32) * g)

    jdv, jdx = jax.grad(jloss, argnums=(0, 1))(jplan.values, jnp.asarray(xb, jnp.bfloat16))
    values = tplan.values.clone().requires_grad_(True)
    x = torch.from_numpy(xb).to(BF16).requires_grad_(True)
    out = spmm_weighted_ad(dataclasses.replace(tplan, values=values), tplan_t, x)
    assert out.dtype == BF16
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert x.grad.dtype == BF16 and jdx.dtype == jnp.bfloat16
    assert_within_ulp(x.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)))
    # the pinned difference: JAX's plane cotangent is float32 whatever the plane
    assert jdv.dtype == jnp.float32
    assert values.grad.dtype == values.dtype
    want = np.asarray(jdv)
    if bf16_plane:
        assert_within_ulp(values.grad.float().numpy(), bf16_np(want))
    else:
        np.testing.assert_allclose(values.grad.numpy(), want, **TOL)


def test_dropedge_bf16_rows_against_jax():
    """The training call on bf16 rows: the planes in the rows' dtype
    (dropedge.py:96-110), K4 forward and K4 over A^T's plane for dx, against
    JAX's arithmetic on the port's keep mask (tests/test_torch_dropedge.py),
    each within one bf16 ulp."""
    a = sp.random(N, N, density=0.04, format="csr", random_state=np.random.default_rng(3))
    a.data[:] = 1.0
    gj = jmodels.build_dropedge_graph(a.indptr, a.indices, N, jfmt.PlanConfig(64, 128),
                                      backend="numpy")
    gt = vt.build_dropedge_graph(a.indptr, a.indices, N, vt.PlanConfig(64, 128), device="cpu")
    rng = np.random.default_rng(4)
    xb = bf16_np(rng.standard_normal((N, 16)).astype(np.float32))
    g = bf16_np(rng.standard_normal((N, 16)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    x = torch.from_numpy(xb).to(BF16).requires_grad_(True)
    out = vt.dropedge_aggregate(gt, x, gen, 0.8)
    out.backward(torch.from_numpy(g).to(BF16))
    gen.set_state(state)
    w = dropedge_weights(gt.num_edges, 0.8, gen, BF16)
    assert out.dtype == BF16 and set(np.unique(w.float().numpy())) <= {0.0, 1.25}

    def plane(plan, slots):
        cfg = plan.config
        size = plan.total_blocks * cfg.block_h * cfg.block_w
        wj = jnp.asarray(w.float().numpy(), jnp.bfloat16)
        return (jnp.zeros(size, jnp.bfloat16).at[slots].add(wj)
                .reshape(plan.total_blocks, cfg.block_h, cfg.block_w))

    jp = dataclasses.replace(gj.plan, values=plane(gj.plan, gj.slots))
    jpt = dataclasses.replace(gj.plan_t, values=plane(gj.plan_t, gj.slots_t))
    want, vjp = jax.vjp(lambda f: jops.spmm_weighted_ad(jp, jpt, f),
                        jnp.asarray(xb, jnp.bfloat16))
    (want_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    assert_within_ulp(out.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert_within_ulp(x.grad.float().numpy(), np.asarray(want_dx.astype(jnp.float32)))


# --- K8 ---------------------------------------------------------------------

def quant_rows(case):
    if case == "normal":
        return np.random.default_rng(14).standard_normal((512, 256)).astype(np.float32)
    # tests/test_torch_quant.py:186-188: exact halves of the scale
    x = np.tile(np.arange(-127, 128, 0.5, dtype=np.float32)[None, :], (3, 1))
    x[:, -1] = 127.0
    return x


@pytest.mark.parametrize("case", ["normal", "ties"])
def test_quantize_rows_bf16_matches_jax(case):
    """quantize_rows of bf16 rows computes in bf16, as jnp does: its codes
    and scales are JAX's bit for bit."""
    xb = torch.from_numpy(quant_rows(case)).to(BF16)
    qj, sj = jops.quantize_rows(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    qt, st = vt.quantize_rows(xb)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    # a bf16 scale, widened: K8's bf16 rounding of it is exact
    assert torch.equal(st, st.to(BF16).float())


def test_quantize_rows_of_widened_rows_differs():
    """The test above has teeth: quantizing the widened rows in float32
    gives other codes and scales than JAX's bf16 quantization."""
    xb = torch.from_numpy(quant_rows("normal")).to(BF16)
    qj, sj = jops.quantize_rows(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    qw, sw = vt.quantize_rows(xb.float())
    assert (qw.numpy() != np.asarray(qj)).sum() > 1000
    assert (sw.numpy() != np.asarray(sj)).mean() > 0.5


@pytest.mark.parametrize("h,d", [(32, 13), (64, 40)])
def test_int8_bf16_rows_against_jax(graph, h, d):
    a = graph["a"]
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(h, 128),
                                backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(h, 128))
    xb = bf16_np(np.random.default_rng(20 + d).standard_normal((N, d)).astype(np.float32) * 3)
    want = jops.spmm_pallas_int8(jplan, jnp.asarray(xb, jnp.bfloat16))
    x16 = torch.from_numpy(xb).to(BF16)
    got = vt.spmm(tplan, x16, impl="int8")
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_within_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(spmm_int8(tplan, x16, out_dtype=torch.float32).to(BF16), got)
    # the refusals JAX has too: compute_dtype and a value plane
    with pytest.raises(NotImplementedError, match="takes no compute_dtype"):
        vt.spmm(tplan, x16, impl="int8", compute_dtype=BF16)
    with pytest.raises(ValueError, match="value plane"):
        spmm_int8(graph[("plan", h, "torch")], x16)


# --- the tuner -----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["weighted", "int8"])
def test_tuner_bf16_variants_return_the_callers_dtype(graph, impl):
    """Variant(impl, feat_dtype="bfloat16") runs K4 or K8 on bf16 rows and
    returns the caller's float32, the float32 sums cast once. JAX's
    _run_variant gives K4 and K8 no out_dtype (tuner.py:676-677,
    :687-690): its result is the caller's dtype holding bf16 values. The
    difference is pinned here (ROADMAP.md §3)."""
    v = Variant(impl, block_h=32, feat_dtype="bfloat16")
    a = graph["a"]
    x = np.random.default_rng(9).standard_normal((N, 16)).astype(np.float32)
    tplan = graph[("plan", 32, "torch")] if impl == "weighted" else vt.csr_preprocess(
        a.indptr, a.indices, N, vt.PlanConfig(32, 128))
    got = _run_variant(v, tplan, torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = vt.spmm(tplan, torch.from_numpy(x).to(BF16), impl=impl, out_dtype=torch.float32)
    assert torch.equal(got, want)
    assert not torch.equal(got, got.to(BF16).float())  # float32 sums, not bf16 values
    jv = jtuner.Variant(impl, block_h=32, feat_dtype="bfloat16")
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(32, 128),
                                backend="numpy",
                                values=a.data.astype(np.float32) if impl == "weighted" else None)
    jout = np.asarray(jtuner._run_variant(jv, jplan, jnp.asarray(x)))
    assert jout.dtype == np.float32
    np.testing.assert_array_equal(jout, bf16_np(jout))  # JAX's: bf16 values
    assert_within_ulp(bf16_np(got.numpy()), jout)
    with pytest.raises(NotImplementedError, match="no compute_dtype"):
        Variant(impl, compute_dtype="bfloat16")


# --- export ----------------------------------------------------------------

def test_export_bf16_weighted_and_int8_calls(graph):
    """A K4 call on bf16 rows and a bf16 plane and a K8 call on bf16 rows,
    exported and loaded: the eager bits, and the voltrix ops in the graph."""
    _, tplan = with_plane(graph[("plan", 64, "jax")], graph[("plan", 64, "torch")], True)
    a = graph["a"]
    bplan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(64, 128))
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((N, 24)).astype(np.float32))
    x16 = x.to(BF16)
    for fn, op in ((lambda f: vt.spmm(tplan, f), "spmm_weighted"),
                   (lambda f: vt.spmm(bplan, f, impl="int8"), "spmm_int8")):
        eager = fn(x16)
        prog = load_servable(export_servable(fn, x16))
        assert torch.equal(prog(x16), eager) and eager.dtype == BF16
        targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
        assert any(op in t for t in targets), targets

"""float16 rows on kernels K4 and K8 against the JAX package on the CPU.

The same numpy-seeded inputs, rounded to float16, go through both
packages; the JAX side runs `spmm_pallas_weighted`, `spmm_weighted_ad` and
`spmm_pallas_int8` in interpret mode, the port its plain versions, which
widen the float16 rows and plane exactly and sum in float32 as K4's and
K8's float16 instantiations do on the card.

- K4 on float16 rows with float32, bf16 and float16 value planes: with
  out_dtype=torch.float32 against JAX on the widened inputs at
  tests/test_spmm.py:32-33's float32 tolerance (float32 sums in another
  order), and the float16 output against JAX's at
  tests/test_torch_f16.py's `F16_TOL`.
- `spmm_weighted_ad`'s gradients against `jax.grad`: dfeat in float16 at
  `F16_TOL`; dvalues against JAX's, whose cotangent is float32 where the
  port's takes the plane's dtype (pinned; ROADMAP.md §3).
- DropEdge on float16 rows against JAX's arithmetic on the same keep mask.
- `quantize_rows` on float16 rows: JAX's codes and scales, equal, with a
  zero row (eps = 1e-30 rounds to 0 in float16: 0 / 0, code 0), a row
  whose scale underflows to 0 (codes +-127 and 0, no contribution) and
  rows of exact halves of the scale; `spmm(impl="int8")` on float16 rows
  against `spmm_pallas_int8`, its float32 sums against JAX's sum of the
  same dequantized rows at rtol / atol 1e-5, and a row past 65,504 that
  becomes inf in both.
- The tuner's float16 K4 and K8 variants run and return the caller's
  dtype, the float32 sums cast once, where JAX's round them through
  float16 first (pinned; ROADMAP.md §3).
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

from test_torch_f16 import F16_TOL

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:32-33
N = 300
F16 = torch.float16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}


def f16_np(x: np.ndarray) -> np.ndarray:
    """float32 numpy values rounded to float16 (round to nearest even), as
    float32."""
    return np.array(x, np.float32).astype(np.float16).astype(np.float32)


def f32(x):
    """A JAX or torch array, any float type, as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


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
    a = weighted_csr(seed=31)
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


def with_plane(jplan, tplan, plane):
    """Both plans with the plane in `plane` ("float32", "bfloat16" or
    "float16": the same rounded values on both sides)."""
    values = tplan.values.to(getattr(torch, plane))
    return (dataclasses.replace(jplan, values=jnp.asarray(values.float().numpy(), JDT[plane])),
            dataclasses.replace(tplan, values=values))


# --- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("h,plane,d", [(32, "float32", 13), (32, "float16", 13),
                                       (64, "bfloat16", 40), (64, "float16", 130),
                                       (64, "float32", 8)])
def test_k4_f16_rows_against_jax(graph, h, plane, d):
    jplan, tplan = with_plane(graph[("plan", h, "jax")], graph[("plan", h, "torch")], plane)
    xh = f16_np(np.random.default_rng(100 + d).standard_normal((N, d)).astype(np.float32))
    x16 = torch.from_numpy(xh).to(F16)
    # JAX on the widened rows and plane: K4's float32 sums
    jplan32 = dataclasses.replace(jplan, values=jnp.asarray(jplan.values, jnp.float32))
    want32 = np.asarray(jops.spmm_pallas_weighted(jplan32, jnp.asarray(xh)))
    got32 = spmm_weighted(tplan, x16, out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want32, **TOL)
    # JAX on the float16 rows and the plane in its type: the float16 output
    want16 = jops.spmm_pallas_weighted(jplan, jnp.asarray(xh, jnp.float16))
    got16 = vt.spmm(tplan, x16)
    assert got16.dtype == F16 and want16.dtype == jnp.float16
    np.testing.assert_allclose(f32(got16), f32(want16), **F16_TOL)
    assert torch.equal(got16, got32.to(F16))


@pytest.mark.parametrize("plane", ["float32", "float16"])
def test_weighted_ad_f16_gradients_against_jax(graph, plane):
    """dfeat is K4 over the transpose plan on the cotangent in the features'
    dtype (JAX weighted.py:334-336), at F16_TOL; dvalues is K5 on widened
    operands. JAX returns dvalues in float32 for a float16 plane; torch
    casts a gradient to its input's dtype, so the port's is float16:
    pinned."""
    jplan, tplan = with_plane(graph[("plan", 64, "jax")], graph[("plan", 64, "torch")], plane)
    jplan_t, tplan_t = with_plane(graph[("plan_t", 64, "jax")], graph[("plan_t", 64, "torch")],
                                  plane)
    rng = np.random.default_rng(37)
    xh = f16_np(rng.standard_normal((N, 24)).astype(np.float32))
    g = rng.standard_normal((N, 24)).astype(np.float32)

    def jloss(values, feat):
        out = jops.spmm_weighted_ad(dataclasses.replace(jplan, values=values), jplan_t, feat)
        return jnp.sum(out.astype(jnp.float32) * g)

    jdv, jdx = jax.grad(jloss, argnums=(0, 1))(jplan.values, jnp.asarray(xh, jnp.float16))
    values = tplan.values.clone().requires_grad_(True)
    x = torch.from_numpy(xh).to(F16).requires_grad_(True)
    out = spmm_weighted_ad(dataclasses.replace(tplan, values=values), tplan_t, x)
    assert out.dtype == F16
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert x.grad.dtype == F16 and jdx.dtype == jnp.float16
    np.testing.assert_allclose(f32(x.grad), f32(jdx), **F16_TOL)
    # the pinned difference: JAX's plane cotangent is float32 whatever the plane
    assert jdv.dtype == jnp.float32
    assert values.grad.dtype == values.dtype
    want = np.asarray(jdv)
    if plane == "float16":
        np.testing.assert_allclose(f32(values.grad), f16_np(want), **F16_TOL)
    else:
        np.testing.assert_allclose(values.grad.numpy(), want, **TOL)


def test_dropedge_f16_rows_against_jax():
    """The training call on float16 rows: the planes in the rows' dtype
    (dropedge.py:96-110), K4 forward and K4 over A^T's plane for dx, against
    JAX's arithmetic on the port's keep mask (tests/test_torch_dropedge.py),
    at F16_TOL."""
    a = sp.random(N, N, density=0.04, format="csr", random_state=np.random.default_rng(33))
    a.data[:] = 1.0
    gj = jmodels.build_dropedge_graph(a.indptr, a.indices, N, jfmt.PlanConfig(64, 128),
                                      backend="numpy")
    gt = vt.build_dropedge_graph(a.indptr, a.indices, N, vt.PlanConfig(64, 128), device="cpu")
    rng = np.random.default_rng(34)
    xh = f16_np(rng.standard_normal((N, 16)).astype(np.float32))
    g = f16_np(rng.standard_normal((N, 16)).astype(np.float32))
    gen = torch.Generator().manual_seed(35)
    state = gen.get_state()
    x = torch.from_numpy(xh).to(F16).requires_grad_(True)
    out = vt.dropedge_aggregate(gt, x, gen, 0.8)
    out.backward(torch.from_numpy(g).to(F16))
    gen.set_state(state)
    w = dropedge_weights(gt.num_edges, 0.8, gen, F16)
    assert out.dtype == F16 and x.grad.dtype == F16
    assert set(np.unique(w.float().numpy())) <= {0.0, 1.25}

    def plane(plan, slots):
        cfg = plan.config
        size = plan.total_blocks * cfg.block_h * cfg.block_w
        wj = jnp.asarray(w.float().numpy(), jnp.float16)
        return (jnp.zeros(size, jnp.float16).at[slots].add(wj)
                .reshape(plan.total_blocks, cfg.block_h, cfg.block_w))

    jp = dataclasses.replace(gj.plan, values=plane(gj.plan, gj.slots))
    jpt = dataclasses.replace(gj.plan_t, values=plane(gj.plan_t, gj.slots_t))
    want, vjp = jax.vjp(lambda f: jops.spmm_weighted_ad(jp, jpt, f),
                        jnp.asarray(xh, jnp.float16))
    (want_dx,) = vjp(jnp.asarray(g, jnp.float16))
    np.testing.assert_allclose(f32(out), f32(want), **F16_TOL)
    np.testing.assert_allclose(f32(x.grad), f32(want_dx), **F16_TOL)


# --- K8 ---------------------------------------------------------------------

def quant_rows(case):
    """Rows for quantize_rows: normal rows with a zero row (row 3) and a row
    of largest value 3e-6 (row 7, its scale underflows to 0 in float16), or
    exact halves of the scale (tests/test_torch_quant.py:186-188)."""
    if case == "normal":
        x = np.random.default_rng(44).standard_normal((512, 256)).astype(np.float32)
        x[3] = 0.0
        x[7] = np.clip(x[7], -1, 1) * 3e-6
        return x
    x = np.tile(np.arange(-127, 128, 0.5, dtype=np.float32)[None, :], (3, 1))
    x[:, -1] = 127.0
    return x


@pytest.mark.parametrize("case", ["normal", "ties"])
def test_quantize_rows_f16_matches_jax(case):
    """quantize_rows of float16 rows computes in float16, as jnp does: its
    codes and scales are JAX's, equal, on the zero row and the row whose
    scale underflows too."""
    xh = torch.from_numpy(quant_rows(case)).to(F16)
    qj, sj = jops.quantize_rows(jnp.asarray(xh.float().numpy(), jnp.float16))
    qt, st = vt.quantize_rows(xh)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    # a float16 scale, widened (K8 rounds it to bf16 as the TPU kernel does)
    assert torch.equal(st, st.to(F16).float())
    if case == "normal":
        assert st[3].item() == 0.0 and not qt[3].any()  # 0 / 0: code 0
        assert st[7].item() == 0.0  # 3e-6 / 127 underflows
        assert set(qt[7].tolist()) <= {-127, 0, 127} and (qt[7] != 0).any()


def test_quantize_rows_of_widened_rows_differs():
    """The test above has teeth: quantizing the widened rows in float32
    gives other codes and scales than JAX's float16 quantization."""
    xh = torch.from_numpy(quant_rows("normal")).to(F16)
    qj, sj = jops.quantize_rows(jnp.asarray(xh.float().numpy(), jnp.float16))
    qw, sw = vt.quantize_rows(xh.float())
    assert (qw.numpy() != np.asarray(qj)).sum() > 100
    assert (sw.numpy() != np.asarray(sj)).mean() > 0.5


@pytest.mark.parametrize("h,d", [(32, 13), (64, 40)])
def test_int8_f16_rows_against_jax(graph, h, d):
    """spmm(impl="int8") on float16 rows: its float32 sums against JAX's
    float32 sum of the rows JAX's K8 dequantizes (bf16(q) bf16(scale), each
    a bf16 value, so any matmul precision sums them exactly) at rtol / atol
    1e-5, and its float16 output against spmm_pallas_int8's within one
    float16 ulp plus the sums' distance."""
    from test_torch_f16 import assert_within_one_ulp

    a = graph["a"]
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(h, 128),
                                backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(h, 128))
    x = np.random.default_rng(50 + d).standard_normal((N, d)).astype(np.float32) * 3
    x[3] = 0.0
    x[7] = np.clip(x[7], -1, 1) * 3e-6
    xh = f16_np(x)
    x16 = torch.from_numpy(xh).to(F16)
    qj, sj = jops.quantize_rows(jnp.asarray(xh, jnp.float16))
    xq = jops.dequantize_rows(qj, sj, jnp.bfloat16).astype(jnp.float32)
    sums = np.asarray(jops.spmm_pallas(jplan, xq))
    got32 = spmm_int8(tplan, x16, out_dtype=torch.float32)
    np.testing.assert_allclose(got32.numpy(), sums, rtol=1e-5, atol=1e-5)
    want = jops.spmm_pallas_int8(jplan, jnp.asarray(xh, jnp.float16))
    got = vt.spmm(tplan, x16, impl="int8")
    assert got.dtype == F16 and want.dtype == jnp.float16
    assert torch.equal(got, got32.to(F16))
    assert_within_one_ulp(got, want, got32, sums)
    # the refusals JAX has too: compute_dtype and a value plane
    with pytest.raises(NotImplementedError, match="takes no compute_dtype"):
        vt.spmm(tplan, x16, impl="int8", compute_dtype=F16)
    with pytest.raises(ValueError, match="value plane"):
        spmm_int8(graph[("plan", h, "torch")], x16)


def test_int8_f16_output_past_the_range_is_inf(graph):
    """A row whose sum passes 65,504 comes out +-inf in float16, in both
    packages (the float32 sums cast once)."""
    a = graph["a"]
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(32, 128),
                                backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(32, 128))
    x = np.random.default_rng(55).standard_normal((N, 8)).astype(np.float32)
    x[:, 0] = 60000.0  # every row's column 0: the sum passes 65,504 on rows of degree >= 2
    xh = f16_np(x)
    got = vt.spmm(tplan, torch.from_numpy(xh).to(F16), impl="int8")
    want = f32(jops.spmm_pallas_int8(jplan, jnp.asarray(xh, jnp.float16)))
    deg = np.diff(a.indptr)
    assert (deg >= 2).any()
    assert np.isposinf(f32(got)[deg >= 2, 0]).all()
    np.testing.assert_array_equal(np.isinf(f32(got)), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(f32(got)[fin], want[fin], **F16_TOL)


# --- the tuner -----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["weighted", "int8"])
def test_tuner_f16_variants_return_the_callers_dtype(graph, impl):
    """Variant(impl, feat_dtype="float16") runs K4 or K8 on float16 rows
    and returns the caller's float32, the float32 sums cast once. JAX's
    _run_variant gives K4 and K8 no out_dtype (tuner.py:676-677,
    :687-690): its result is the caller's dtype holding float16 values. The
    difference is pinned here (ROADMAP.md §3)."""
    v = Variant(impl, block_h=32, feat_dtype="float16")
    a = graph["a"]
    x = np.random.default_rng(39).standard_normal((N, 16)).astype(np.float32)
    tplan = graph[("plan", 32, "torch")] if impl == "weighted" else vt.csr_preprocess(
        a.indptr, a.indices, N, vt.PlanConfig(32, 128))
    got = _run_variant(v, tplan, torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = vt.spmm(tplan, torch.from_numpy(x).to(F16), impl=impl, out_dtype=torch.float32)
    assert torch.equal(got, want)
    assert not torch.equal(got, got.to(F16).float())  # float32 sums, not float16 values
    jv = jtuner.Variant(impl, block_h=32, feat_dtype="float16")
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(32, 128),
                                backend="numpy",
                                values=a.data.astype(np.float32) if impl == "weighted" else None)
    jout = np.asarray(jtuner._run_variant(jv, jplan, jnp.asarray(x)))
    assert jout.dtype == np.float32
    np.testing.assert_array_equal(jout, f16_np(jout))  # JAX's: float16 values
    np.testing.assert_allclose(f16_np(got.numpy()), jout, **F16_TOL)
    with pytest.raises(NotImplementedError, match="no compute_dtype"):
        Variant(impl, compute_dtype="float16")


# --- export ----------------------------------------------------------------

def test_export_f16_weighted_and_int8_calls(graph):
    """A K4 call on float16 rows and a float16 plane and a K8 call on
    float16 rows, exported and loaded: the eager bits, and the voltrix ops in
    the graph."""
    _, tplan = with_plane(graph[("plan", 64, "jax")], graph[("plan", 64, "torch")], "float16")
    a = graph["a"]
    bplan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(64, 128))
    x = torch.from_numpy(np.random.default_rng(41).standard_normal((N, 24)).astype(np.float32))
    x16 = x.to(F16)
    for fn, op in ((lambda f: vt.spmm(tplan, f), "spmm_weighted"),
                   (lambda f: vt.spmm(bplan, f, impl="int8"), "spmm_int8")):
        eager = fn(x16)
        prog = load_servable(export_servable(fn, x16))
        assert torch.equal(prog(x16), eager) and eager.dtype == F16
        targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
        assert any(op in t for t in targets), targets

"""Parity of the PyTorch port's ELL path with the JAX package on the CPU:
`csr_preprocess_ell`, `ell_transpose` and `build_ell_pair` bit for bit,
`lane_values` / `edge_values`, `slice_ell_windows` and `save` / `load`
across the packages; the plain versions of kernels K6 (`spmm_ell`) and
K7 (`spmm_ell_dvals`) against the JAX package's Pallas kernels in
interpret mode; `spmm_ell_streamed`, the `spmm` dispatch of an EllPlan;
and the gradients of `spmm_ell_ad` and `sddmm_ell_ad` against `jax.grad`;
K7's source order (`ell_source_order`: each real lane once, grouped by
window and source row, in lane order within a source) and its wide
kernel's arithmetic over it, piece by piece, against `spmm_ell_dvals`.

The kernels run only on the card and are checked against the same plain
versions there by chip_smoke.py. Outputs use tests/test_spmm.py:51-52's
tolerance (rtol 1e-5, atol 1e-4: float32 sums in another order), as the
port's other kernel tests do; sums against a float64 scipy product use
tests/test_ell.py:46's rtol 1e-4, atol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.format as tfmt
from voltrix_spmm_tpu.format.ell import EllPlan as JaxEllPlan
from voltrix_spmm_tpu_torch.ops import (
    sddmm_ell,
    spmm_ell,
    spmm_ell_dvals,
    spmm_ell_dvals_reference,
    spmm_ell_reference,
    spmm_ell_streamed,
)
from voltrix_spmm_tpu_torch.ops import ell as tell
from voltrix_spmm_tpu_torch.ops.ell import (
    _k6_lanes,
    _k7_geometry,
    _k7_wide,
    ell_row_order,
    ell_source_order,
    plan_sources,
)

TOL = dict(rtol=1e-5, atol=1e-4)
TOL_SCIPY = dict(rtol=1e-4, atol=1e-3)
FIELDS = ("hind", "erow", "vals", "window_of_block", "block_ptr", "edge_lane", "lane_edge")
META = ("num_nodes", "num_edges", "num_windows", "total_blocks", "has_empty_windows", "num_cols",
        "padded_nodes", "source_rows", "gather_rows")


def weighted_csr(n, density, seed, num_cols=None):
    rng = np.random.default_rng(seed)
    a = sp.random(n, num_cols or n, density=density, format="csr", random_state=rng)
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    return a


def drop_rows(a, keep):
    mask = np.array([keep(r) for r in range(a.shape[0])], dtype=np.float32)
    out = (sp.diags(mask) @ a).tocsr()
    out.eliminate_zeros()
    return out


def with_duplicates(a, seed):
    """The CSR of `a` with a tenth of its edges repeated (other values),
    rows kept sorted: duplicate edges keep separate lanes."""
    rng = np.random.default_rng(seed)
    coo = a.tocoo()
    pick = rng.random(coo.nnz) < 0.1
    rows = np.concatenate([coo.row, coo.row[pick]])
    cols = np.concatenate([coo.col, coo.col[pick]])
    vals = np.concatenate([coo.data, rng.standard_normal(int(pick.sum()))]).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(a.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=a.shape[0]), out=indptr[1:])
    return indptr, cols[order], vals[order]


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def plan_case(case):
    """(indptr, indices, values, n, num_cols, cfg) of a named geometry."""
    if case == "h128":
        a = weighted_csr(500, 0.02, 1)
        return a.indptr, a.indices, a.data, 500, None, dict(block_h=128)
    if case == "h128_unroll4":
        a = weighted_csr(600, 0.004, 2)
        return a.indptr, a.indices, a.data, 600, None, dict(block_h=128, block_unroll=4)
    if case == "h32_unroll4":
        a = weighted_csr(301, 0.03, 3)
        return a.indptr, a.indices, a.data, 301, None, dict(block_h=32, block_unroll=4)
    if case == "duplicates":
        indptr, indices, values = with_duplicates(weighted_csr(400, 0.03, 4), seed=4)
        return indptr, indices, values, 400, None, dict(block_h=64)
    if case == "padded_empty_windows":
        a = drop_rows(weighted_csr(600, 0.01, 5), lambda r: not 128 <= r < 256)
        return a.indptr, a.indices, a.data, 600, None, dict(block_h=128, block_unroll=2)
    if case == "left_empty_windows":
        a = drop_rows(weighted_csr(4096, 0.005, 6), lambda r: r < 32)
        return a.indptr, a.indices, a.data, 4096, None, dict(block_h=32)
    if case == "rectangular":
        a = weighted_csr(300, 0.02, 7, num_cols=450)
        return a.indptr, a.indices, a.data, 300, 450, dict(block_h=128)
    if case == "empty_matrix":
        a = weighted_csr(100, 0.0, 8)
        return a.indptr, a.indices, a.data, 100, None, dict(block_h=64)
    assert case == "binary_w256"
    a = weighted_csr(500, 0.02, 9)
    return a.indptr, a.indices, None, 500, None, dict(block_h=64, block_w=256)


CASES = ["h128", "h128_unroll4", "h32_unroll4", "duplicates", "padded_empty_windows",
         "left_empty_windows", "rectangular", "empty_matrix", "binary_w256"]


def both_ell(case):
    indptr, indices, values, n, num_cols, cfg = plan_case(case)
    jplan = jfmt.csr_preprocess_ell(indptr, indices, n, jfmt.PlanConfig(**cfg), values=values,
                                    num_cols=num_cols)
    tplan = vt.csr_preprocess_ell(indptr, indices, n, vt.PlanConfig(**cfg), values=values,
                                  num_cols=num_cols)
    return jplan, tplan


def assert_same_ell(jplan, tplan):
    for name in FIELDS:
        t, j = getattr(tplan, name), np.asarray(getattr(jplan, name))
        assert t.dtype == (torch.float32 if name == "vals" else torch.int32), name
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy().view(np.uint32), j.view(np.uint32), err_msg=name)
    for name in META:
        assert getattr(tplan, name) == getattr(jplan, name), name
    assert dataclasses.asdict(tplan.config) == dataclasses.asdict(jplan.config)


def assert_close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    if out.size:
        assert vt.calc_diff(out, ref) < 1e-6
    np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("case", CASES)
def test_ell_plan_bit_identical(case):
    jplan, tplan = both_ell(case)
    assert_same_ell(jplan, tplan)
    assert tfmt.ell_stats(tplan) == jfmt.ell_stats(jplan)
    if case == "left_empty_windows":
        assert tplan.has_empty_windows
    if case == "duplicates":
        assert tplan.num_edges == plan_case(case)[1].shape[0]  # one lane per edge, repeats too


@pytest.mark.parametrize("case", ["h128", "duplicates", "rectangular", "h32_unroll4"])
def test_ell_transpose_and_pair_bit_identical(case):
    indptr, indices, values, n, num_cols, cfg = plan_case(case)
    jt = jfmt.ell_transpose(indptr, indices, n, values=values, config=jfmt.PlanConfig(**cfg),
                            num_cols=num_cols)
    tt = tfmt.ell_transpose(indptr, indices, n, values=values, config=vt.PlanConfig(**cfg),
                            num_cols=num_cols)
    assert_same_ell(jt, tt)
    cfg_t = dict(cfg, block_h=64)  # a pair may take another geometry for A^T
    jp, jpt = jfmt.build_ell_pair(indptr, indices, n, values=values, config=jfmt.PlanConfig(**cfg),
                                  config_t=jfmt.PlanConfig(**cfg_t), num_cols=num_cols)
    tp, tpt = tfmt.build_ell_pair(indptr, indices, n, values=values, config=vt.PlanConfig(**cfg),
                                  config_t=vt.PlanConfig(**cfg_t), num_cols=num_cols)
    assert_same_ell(jp, tp)
    assert_same_ell(jpt, tpt)
    # both edge maps in A's CSR order: one per-edge vector feeds either side
    w = torch.from_numpy(features(1, indices.shape[0], seed=3)[0])
    assert torch.equal(tfmt.edge_values(tpt, tfmt.lane_values(tpt, w)), w)


def test_ell_plan_refuses_bad_input():
    a = weighted_csr(256, 0.05, 10)
    with pytest.raises(ValueError, match="exact edges"):
        vt.csr_preprocess_ell(a.indptr, a.indices, 256, vt.PlanConfig(128, 128, gather_segment=4))
    with pytest.raises(ValueError, match="align"):
        vt.csr_preprocess_ell(a.indptr, a.indices, 256, values=a.data[:-1])
    with pytest.raises(ValueError, match="bad CSR"):
        vt.csr_preprocess_ell(a.indptr, a.indices, 255)


@pytest.mark.parametrize("case", ["h128", "duplicates", "padded_empty_windows"])
def test_lane_values_roundtrip_matches_jax(case):
    jplan, tplan = both_ell(case)
    values = plan_case(case)[2]
    plane = tfmt.lane_values(tplan, torch.from_numpy(values))
    jplane = np.asarray(jfmt.lane_values(jplan, jnp.asarray(values)))
    np.testing.assert_array_equal(plane.numpy(), jplane)
    np.testing.assert_array_equal(plane.numpy(), tplan.vals.numpy())
    back = tfmt.edge_values(tplan, plane)
    np.testing.assert_array_equal(back.numpy(), values)
    np.testing.assert_array_equal(tfmt.edge_values(tplan).numpy(),
                                  np.asarray(jfmt.edge_values(jplan)))


def test_lane_values_gradient_is_a_gather():
    """d plane / d w is the gather through edge_lane: every edge gets its
    lane's gradient, and the padding lanes give nobody anything."""
    _, tplan = both_ell("h128_unroll4")
    w = torch.from_numpy(plan_case("h128_unroll4")[2]).requires_grad_(True)
    g = torch.from_numpy(features(tplan.total_blocks, tplan.config.block_w, seed=4))
    (tfmt.lane_values(tplan, w) * g).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), g.reshape(-1)[tplan.edge_lane.long()].numpy())
    with pytest.raises(ValueError, match="must be"):
        tfmt.lane_values(tplan, w[:-1])


@pytest.mark.parametrize("chunks", [1, 3, 8])
def test_slice_ell_windows_matches_jax(chunks):
    jplan, tplan = both_ell("left_empty_windows")
    jsubs = jfmt.slice_ell_windows(jplan, chunks)
    tsubs = tfmt.slice_ell_windows(tplan, chunks)
    assert len(tsubs) == len(jsubs)
    for j, t in zip(jsubs, tsubs):
        for name in FIELDS[:5]:
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)
        assert t.edge_lane is None and t.lane_edge is None
        for name in META:
            assert getattr(t, name) == getattr(j, name), name


def test_save_load_across_packages(tmp_path):
    jplan, tplan = both_ell("duplicates")
    back_j = JaxEllPlan.load(tplan.save(str(tmp_path / "from_torch")))
    assert_same_ell(back_j, tplan)
    back_t = tfmt.EllPlan.load(jplan.save(str(tmp_path / "from_jax")))
    assert_same_ell(jplan, back_t)
    # a window slice has no edge maps, and round-trips without them
    sub = tfmt.slice_ell_windows(tplan, 2)[1]
    again = tfmt.EllPlan.load(sub.save(str(tmp_path / "slice.npz")))
    assert again.edge_lane is None and torch.equal(again.hind, sub.hind)


@pytest.mark.parametrize("d", [1, 8, 40, 64])
@pytest.mark.parametrize("case", ["h128", "h32_unroll4", "duplicates", "rectangular"])
def test_spmm_ell_matches_jax(d, case):
    jplan, tplan = both_ell(case)
    indptr, indices, values, n, num_cols, _ = plan_case(case)
    x = features(num_cols or n, d, seed=d)
    ref = np.asarray(jops.spmm_ell(jplan, jnp.asarray(x)))
    calls = spmm_ell_reference.calls
    out = spmm_ell(tplan, torch.from_numpy(x))
    assert spmm_ell_reference.calls == calls + 1  # the plain version on a CPU tensor
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, d)
    assert_close(out, ref)
    a = sp.csr_matrix((values, indices, indptr), shape=(n, num_cols or n))  # duplicates sum
    np.testing.assert_allclose(out.numpy(), a @ x.astype(np.float64), **TOL_SCIPY)


@pytest.mark.parametrize("case", ["padded_empty_windows", "left_empty_windows", "empty_matrix",
                                  "binary_w256", "h128_unroll4"])
def test_spmm_ell_edge_cases_match_jax(case):
    jplan, tplan = both_ell(case)
    n = tplan.num_nodes
    x = features(n, 24, seed=11)
    out = spmm_ell(tplan, torch.from_numpy(x))
    assert_close(out, np.asarray(jops.spmm_ell(jplan, jnp.asarray(x))))
    if case == "left_empty_windows":
        assert not out[32:].any()
    if case == "empty_matrix":
        assert tplan.total_blocks > 0 and not out.any()  # padding blocks, erow -1


def test_padding_lanes_ignore_their_values():
    """Non-zero values on padding lanes add nothing in either package."""
    jplan, tplan = both_ell("h128_unroll4")
    pad = tplan.erow.numpy() < 0
    assert pad.any()
    vals = tplan.vals.numpy().copy()
    vals[pad] = 7.5
    tp = dataclasses.replace(tplan, vals=torch.from_numpy(vals))
    jp = dataclasses.replace(jplan, vals=vals)
    x = features(600, 16, seed=12)
    out = spmm_ell(tp, torch.from_numpy(x))
    assert torch.equal(out, spmm_ell(tplan, torch.from_numpy(x)))
    assert_close(out, np.asarray(jops.spmm_ell(jp, jnp.asarray(x))))


@pytest.mark.parametrize("d", [1, 8, 40])
@pytest.mark.parametrize("case", ["h128", "h128_unroll4", "duplicates", "rectangular",
                                  "left_empty_windows"])
def test_spmm_ell_dvals_matches_jax(d, case):
    jplan, tplan = both_ell(case)
    n, num_cols = plan_case(case)[3:5]
    feat, g = features(num_cols or n, d, seed=13), features(n, d, seed=14)
    ref = np.asarray(jops.spmm_ell_dvals(jplan, jnp.asarray(feat), jnp.asarray(g)))
    calls = spmm_ell_dvals_reference.calls
    out = spmm_ell_dvals(tplan, torch.from_numpy(feat), torch.from_numpy(g))
    assert spmm_ell_dvals_reference.calls == calls + 1
    assert_close(out, ref)
    pad = tplan.erow.numpy() < 0
    assert (out.numpy()[pad] == 0.0).all()  # exactly zero on padding lanes
    rows = np.repeat(np.arange(n), np.diff(plan_case(case)[0]))
    want = np.einsum("ed,ed->e", g[rows].astype(np.float64), feat[plan_case(case)[1]])
    np.testing.assert_allclose(tfmt.edge_values(tplan, out).numpy(), want, **TOL)


def test_dvals_empty_plan_and_checks():
    jplan, tplan = both_ell("empty_matrix")
    out = spmm_ell_dvals(tplan, torch.ones(100, 8), torch.ones(100, 8))
    assert tuple(out.shape) == (tplan.total_blocks, 128) and not out.any()
    assert np.abs(np.asarray(jops.spmm_ell_dvals(jplan, jnp.ones((100, 8)),
                                                 jnp.ones((100, 8))))).max() == 0.0
    none = vt.csr_preprocess_ell(np.zeros(12801, np.int64), np.zeros(0, np.int64), 12800)
    assert none.total_blocks == 0  # empty windows dominate: no padding blocks
    ones = torch.ones(12800, 4)
    assert tuple(spmm_ell_dvals(none, ones, ones).shape) == (0, 128)
    assert not spmm_ell(none, ones).any()
    _, tplan = both_ell("h128")
    with pytest.raises(ValueError, match="g must be"):
        spmm_ell_dvals(tplan, torch.zeros(500, 8), torch.zeros(500, 9))
    with pytest.raises(ValueError, match="feat must be"):
        spmm_ell(tplan, torch.zeros(499, 8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm_ell(tplan.to("meta"), torch.zeros(500, 8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm_ell_dvals(tplan.to("meta"), torch.zeros(500, 8, device="meta"),
                       torch.zeros(500, 8, device="meta"))


def test_plain_versions_chunks_are_bit_equal():
    _, tplan = both_ell("duplicates")
    x = torch.from_numpy(features(400, 40, seed=15))
    g = torch.from_numpy(features(400, 40, seed=16))
    assert torch.equal(spmm_ell_reference(tplan, x), spmm_ell_reference(tplan, x, chunk_bytes=1))
    assert torch.equal(spmm_ell_dvals_reference(tplan, x, g),
                       spmm_ell_dvals_reference(tplan, x, g, chunk_bytes=1))


@pytest.mark.parametrize("chunks", [1, 3])
def test_spmm_ell_streamed_matches(chunks):
    jplan, tplan = both_ell("left_empty_windows")
    x = features(4096, 16, seed=17)
    full = spmm_ell(tplan, torch.from_numpy(x))
    out = spmm_ell_streamed(tplan, torch.from_numpy(x), num_chunks=chunks)
    assert_close(out, full.numpy())
    subs = tfmt.slice_ell_windows(tplan, chunks)
    assert torch.equal(spmm_ell_streamed(subs, torch.from_numpy(x)), out)
    ref = np.asarray(jops.spmm_ell_streamed(jplan, jnp.asarray(x), num_chunks=chunks))
    assert_close(out, ref)


def test_spmm_dispatches_an_ell_plan():
    jplan, tplan = both_ell("h128")
    x = torch.from_numpy(features(500, 32, seed=18))
    ref = np.asarray(jops.spmm(jplan, jnp.asarray(x.numpy())))  # JAX "auto" -> ell
    calls = spmm_ell_reference.calls
    out = vt.spmm(tplan, x)
    assert_close(out, ref)
    assert torch.equal(vt.spmm(tplan, x, impl="ell"), out)
    assert torch.equal(vt.spmm(tplan, x, impl="reference"), out)
    assert spmm_ell_reference.calls == calls + 3
    assert vt.spmm(tplan, x, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    xb = torch.from_numpy(np.stack([features(500, 8, seed=19), features(500, 8, seed=20)]))
    outb = vt.spmm(tplan, xb)
    assert torch.allclose(outb[1], vt.spmm(tplan, xb[1].contiguous()), **TOL)
    for impl in ("pregather", "fused", "weighted"):
        with pytest.raises(ValueError, match="EllPlan runs"):
            vt.spmm(tplan, x, impl=impl)
    binary = vt.csr_preprocess(np.zeros(501, np.int64), np.zeros(0, np.int64), 500)
    with pytest.raises(ValueError, match="needs an EllPlan"):
        vt.spmm(binary, x, impl="ell")
    # int8 runs K8 (its plain version on the CPU): zeros on the empty plan;
    # "hybrid" is no impl of ops.spmm, as in the JAX package
    assert not vt.spmm(binary, x, impl="int8").any()
    with pytest.raises(ValueError, match="unknown impl"):
        vt.spmm(binary, x, impl="hybrid")


def ell_pairs(a, n, cfg):
    jp, jpt = jfmt.build_ell_pair(a.indptr, a.indices, n, values=a.data,
                                  config=jfmt.PlanConfig(**cfg))
    tp, tpt = tfmt.build_ell_pair(a.indptr, a.indices, n, values=a.data,
                                  config=vt.PlanConfig(**cfg))
    return jp, jpt, tp, tpt


@pytest.mark.parametrize("cfg", [dict(block_h=64), dict(block_h=32, block_unroll=4)])
def test_spmm_ell_ad_gradients_match_jax(cfg):
    """Per-edge parameters -> lane_values on both plans -> spmm_ell_ad: the
    gradients in the features and in the edge parameters as jax.grad has
    them (tests/test_ell.py:186-211 for the same quantity)."""
    n, d = 250, 24
    a = weighted_csr(n, 0.04, 21)
    jp, jpt, tp, tpt = ell_pairs(a, n, cfg)
    x, w = features(n, d, seed=22), features(n, d, seed=23)

    def jloss(xj, e):
        p = dataclasses.replace(jp, vals=jfmt.lane_values(jp, e))
        pt = dataclasses.replace(jpt, vals=jfmt.lane_values(jpt, e))
        return jnp.sum(jops.spmm_ell_ad(p, pt, xj) * w)

    gx, ge = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a.data))
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(a.data.copy()).requires_grad_(True)
    p = dataclasses.replace(tp, vals=tfmt.lane_values(tp, et))
    pt = dataclasses.replace(tpt, vals=tfmt.lane_values(tpt, et))
    k6, k7 = spmm_ell_reference.calls, spmm_ell_dvals_reference.calls
    out = vt.spmm_ell_ad(p, pt, xt)
    (out * torch.from_numpy(w)).sum().backward()
    # forward, dfeat over plan_t, dvals over plan: two K6 and one K7 (plain here)
    assert (spmm_ell_reference.calls - k6, spmm_ell_dvals_reference.calls - k7) == (2, 1)
    assert_close(out.detach(), a @ x, TOL_SCIPY)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), **TOL)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    np.testing.assert_allclose(et.grad.numpy(), np.sum(w[rows] * x[a.indices], axis=1), **TOL)


def test_spmm_ell_ad_launches_only_the_sides_needed():
    n, d = 200, 16
    a = weighted_csr(n, 0.05, 24)
    _, _, tp, tpt = ell_pairs(a, n, dict(block_h=64))
    w = torch.from_numpy(features(n, d, seed=25))
    x = torch.from_numpy(features(n, d, seed=26))
    vals = tp.vals.clone().requires_grad_(True)
    k6, k7 = spmm_ell_reference.calls, spmm_ell_dvals_reference.calls
    # values only: no feature gradient, so plan_t is never read
    (vt.spmm_ell_ad(dataclasses.replace(tp, vals=vals), None, x) * w).sum().backward()
    assert (spmm_ell_reference.calls - k6, spmm_ell_dvals_reference.calls - k7) == (1, 1)
    assert vals.grad is not None
    xt = x.clone().requires_grad_(True)
    k6, k7 = spmm_ell_reference.calls, spmm_ell_dvals_reference.calls
    (vt.spmm_ell_ad(tp, tpt, xt) * w).sum().backward()  # feat only: no K7
    assert (spmm_ell_reference.calls - k6, spmm_ell_dvals_reference.calls - k7) == (2, 0)
    with pytest.raises(ValueError, match="unknown impl"):
        vt.spmm_ell_ad(tp, tpt, x, impl="weighted")
    with pytest.raises(ValueError, match="plan_t"):
        (vt.spmm_ell_ad(tp, None, xt) * w).sum().backward()


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_sddmm_ell_ad_gradients_match_jax(impl):
    """jax.grad through sddmm_ell_ad, for x and y (tests/test_ell.py:230-257
    for the same quantity); the backward is two K6 launches."""
    n, d = 150, 16
    a = weighted_csr(n, 0.05, 27)
    jp, jpt, tp, tpt = ell_pairs(a, n, dict(block_h=64))
    x, y = features(n, d, seed=28), features(n, d, seed=29)
    coeff = features(1, a.nnz, seed=30)[0]

    def jloss(xj, yj):
        return jnp.sum(jnp.tanh(jops.sddmm_ell_ad(jp, jpt, xj, yj)) * coeff)

    wx, wy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    k6, k7 = spmm_ell_reference.calls, spmm_ell_dvals_reference.calls
    e = vt.sddmm_ell_ad(tp, tpt, xt, yt, impl=impl)
    (torch.tanh(e) * torch.from_numpy(coeff)).sum().backward()
    assert (spmm_ell_reference.calls - k6, spmm_ell_dvals_reference.calls - k7) == (2, 1)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    np.testing.assert_allclose(e.detach().numpy(), np.sum(x[rows] * y[a.indices], axis=1), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wx), **TOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(wy), **TOL)


def test_sddmm_ell_matches_jax():
    jplan, tplan = both_ell("duplicates")
    x, y = features(400, 40, seed=31), features(400, 40, seed=32)
    per_edge = sddmm_ell(tplan, torch.from_numpy(x), torch.from_numpy(y), per_edge=True)
    ref = jops.sddmm_ell(jplan, jnp.asarray(x), jnp.asarray(y), per_edge=True)
    np.testing.assert_allclose(per_edge.numpy(), np.asarray(ref), **TOL)
    plane = sddmm_ell(tplan, torch.from_numpy(x), torch.from_numpy(y))
    assert_close(plane, np.asarray(jops.sddmm_ell(jplan, jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("block_h,block_w,d,geometry", [
    (128, 128, 8, (4, 2, 1)), (128, 128, 40, (4, 16, 4)), (128, 128, 256, (4, 32, 4)),
    (32, 128, 1, (1, 1, 1)), (2048, 128, 64, (4, 16, 4)), (8192, 128, 64, (4, 16, 4)),
])
def test_k6_geometry(block_h, block_w, d, geometry):
    """K6's (vec, threads an edge, edges a thread gathers at once): set by
    d and the alignment alone, whatever the window (K6 holds no window
    tile); a warp keeps about 8 edges in flight, and without 16-byte
    alignment a thread takes one column."""
    vec, tpe, unroll = _k6_lanes(d, aligned=True)
    assert (vec, tpe, unroll) == geometry
    assert tpe * vec >= min(d, 128) and 32 // tpe * unroll >= min(8, 32 // tpe)
    assert _k6_lanes(d, aligned=False)[0] == 1
    plan = vt.csr_preprocess_ell(np.zeros(301, np.int64), np.zeros(0, np.int64), 300,
                                 vt.PlanConfig(block_h, block_w))
    # every row of a plan without edges still gets one (empty) piece
    assert ell_row_order(plan, 8).items.shape == (300, 4)


def test_k6_refuses_a_window_too_tall():
    """K6's row order indexes rows with 32-bit ints: a plan whose windows
    reach past row 2**31 - 1 is refused (a tall window alone is not, as K6
    holds no window tile)."""
    indptr, indices, values, n, _, _ = plan_case("h128")
    tall = vt.csr_preprocess_ell(indptr, indices, n, vt.PlanConfig(60000, 128), values=values)
    rows = ell_row_order(tall, 8)
    assert rows.lane.shape == (len(indices),) and rows.items.shape[0] >= n
    past = dataclasses.replace(tall, num_nodes=2**31)
    with pytest.raises(ValueError, match="32-bit"):
        ell_row_order(past, 8)


@pytest.mark.parametrize("d,aligned,geometry", [
    (8, True, (4, 1)), (40, True, (4, 8)), (256, True, (4, 32)), (1, True, (1, 1)),
    (100, True, (4, 16)), (40, False, (1, 32)), (30, True, (1, 16)),
])
def test_k7_geometry(d, aligned, geometry):
    assert _k7_geometry(d, aligned) == geometry


def window_of_lanes(plan):
    return plan.window_of_block.long().repeat_interleave(plan.config.block_w)


@pytest.mark.parametrize("piece_lanes", [1, 7, 64, 4096])
@pytest.mark.parametrize("case", ["h128", "h128_unroll4", "duplicates", "padded_empty_windows",
                                  "left_empty_windows", "rectangular", "empty_matrix"])
def test_source_order_groups_each_lane_once_by_source(case, piece_lanes):
    _, tplan = both_ell(case)
    H = tplan.config.block_h
    order = ell_source_order(tplan, piece_lanes)
    erow = tplan.erow.reshape(-1).long()
    win = window_of_lanes(tplan)
    real = torch.nonzero((erow >= 0) & (win * H + erow < tplan.num_nodes)).squeeze(1)
    lane, src, w = order.lane.long(), order.src.long(), win[order.lane.long()]
    assert sorted(lane.tolist()) == real.tolist()  # each non-padding lane once
    key = w * tplan.source_rows + src
    assert bool((key[1:] >= key[:-1]).all())  # grouped by window, then source
    same = key[1:] == key[:-1]
    assert bool((lane[1:][same] > lane[:-1][same]).all())  # lane order within a source
    clipped = tplan.hind.reshape(-1)[lane].long().clamp(0, tplan.source_rows - 1)
    assert torch.equal(src, clipped) and torch.equal(order.row.long(), erow[lane])
    pieces = order.pieces.long()
    if not len(lane):
        assert pieces.shape == (0, 3)
        return
    assert pieces[0, 1] == 0 and pieces[-1, 2] == len(lane)
    assert torch.equal(pieces[1:, 1], pieces[:-1, 2])  # consecutive, no gap or overlap
    sizes = pieces[:, 2] - pieces[:, 1]
    assert bool((sizes >= 1).all()) and bool((sizes <= piece_lanes).all())
    assert torch.equal(w[pieces[:, 1]], pieces[:, 0]) and torch.equal(w[pieces[:, 2] - 1],
                                                                       pieces[:, 0])


@pytest.mark.parametrize("d", [128, 256, 300])
@pytest.mark.parametrize("case", ["h128_unroll4", "duplicates", "left_empty_windows",
                                  "rectangular"])
def test_source_order_dots_match_jax(d, case):
    """K7's wide kernel in plain torch: each piece's lanes, in source order,
    dotted with their window's g rows and scattered to their lanes, the
    rest 0.0, against JAX's `spmm_ell_dvals` in interpret mode."""
    jplan, tplan = both_ell(case)
    n, num_cols = plan_case(case)[3:5]
    feat, g = features(num_cols or n, d, seed=17), features(n, d, seed=18)
    H = tplan.config.block_h
    order = ell_source_order(tplan, 64)
    ft, gt = torch.from_numpy(feat), torch.from_numpy(g)
    out = torch.zeros(tplan.gather_rows)
    for w, f0, f1 in order.pieces.tolist():
        rows = w * H + order.row[f0:f1].long()
        out[order.lane[f0:f1].long()] = (gt[rows] * ft[order.src[f0:f1].long()]).sum(1)
    ref = np.asarray(jops.spmm_ell_dvals(jplan, jnp.asarray(feat), jnp.asarray(g)))
    assert_close(out.view(tplan.total_blocks, -1), ref)
    assert_close(out.view(tplan.total_blocks, -1),
                 spmm_ell_dvals_reference(tplan, ft, gt))


@pytest.mark.parametrize("case", [
    (tell.DVALS_WIDE_MIN_D, 128, True, True), (256, 128, True, True), (300, 128, True, True),
    (tell.DVALS_WIDE_MIN_D - 4, 128, True, False), (8, 128, True, False),
    (40, 128, True, False), (256, 128, False, False), (130, 128, True, False),
    (512, 64, True, True), (516, 64, True, False), (256, 2048, True, False),
])
def test_k7_wide_rule(case):
    d, block_h, aligned, wide = case
    assert _k7_wide(d, block_h, aligned) == wide


def test_plan_sources_is_kept_beside_the_lanes():
    _, tplan = both_ell("duplicates")
    order = plan_sources(tplan)
    assert plan_sources(tplan) is order and order.piece_lanes == tell.DVALS_PIECE_LANES
    assert plan_sources(dataclasses.replace(tplan, vals=tplan.vals * 2)) is order
    assert plan_sources(dataclasses.replace(tplan, erow=tplan.erow.clone())) is not order
    assert "_sources" not in {f.name for f in dataclasses.fields(tplan)}

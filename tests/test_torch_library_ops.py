"""The registered ops of kernels K4-K15 (ops/library.py) on the CPU, where
each op's body is its kernel's plain version: `torch.library.opcheck` on
each (schema, fake, autograd registration and dispatch, with gradients
where the JAX op has one: K4, K6, K7, K9 and K13), each op's output
against its plain version (bit for bit: the op runs it) and, with its
gradients, against the JAX op on the same plan arrays (Pallas in
interpret mode, as the JAX package's tests run it on the CPU), at the
port's tolerances: weighted and ELL rtol 1e-5, atol 1e-4
(tests/test_torch_weighted.py, tests/test_torch_ell.py), attention
FWD_TOL and GRAD_TOL (tests/test_torch_attention.py), int8 1e-5
(tests/test_torch_quant.py). On the card the same ops launch the kernels;
chip_smoke.py holds them to these plain versions there.
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
from voltrix_spmm_tpu.ops import spmm_attention_ad as jax_attention_ad
from voltrix_spmm_tpu.ops import spmm_attention_mh_ad as jax_mh_ad
from voltrix_spmm_tpu_torch.ops import library as L
from voltrix_spmm_tpu_torch.ops import quant
from voltrix_spmm_tpu_torch.ops.attention import (attention_bwd_reference, attention_dkv_reference,
                                                  attention_dq_reference, plan_lane_sources,
                                                  spmm_attention_reference,
                                                  sum_slots_reference)
from voltrix_spmm_tpu_torch.ops.attention_mh import (attention_mh_dkv_reference,
                                                     attention_mh_dq_reference,
                                                     spmm_attention_mh_reference)
from voltrix_spmm_tpu_torch.ops.ell import spmm_ell_dvals_reference, spmm_ell_reference
from voltrix_spmm_tpu_torch.ops.weighted import (spmm_weighted_dvalues_reference,
                                                 spmm_weighted_reference)

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_torch_weighted.py:45, test_torch_ell.py:51
FWD_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_attention.py:56-57
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
INT8_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_quant.py:34
N = 200
CPU = torch.device("cpu")


def graph(seed, n=N, density=0.04, weighted=False):
    """A symmetric random graph from a numpy seed; with `weighted`, its
    edges carry standard normal values."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    a = ((a + a.T) != 0).astype(np.float32).tocsr()
    a.sort_indices()
    if weighted:
        a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    return a


def feats(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def op_check(op, args):
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def absent(ops, geom):
    return L.no_plan(ops, geom)


# --- K4 and K5 -------------------------------------------------------------------------

def weighted_pair(seed, cfg=dict(block_h=64)):
    a = graph(seed, weighted=True)
    jp = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(**cfg), backend="numpy",
                             values=a.data)
    ptr_t, idx_t, vals_t = jfmt.csr_transpose(a.indptr, a.indices, N, a.data)
    jpt = jfmt.csr_preprocess(ptr_t, idx_t, N, jfmt.PlanConfig(**cfg), backend="numpy",
                              values=vals_t)
    tp = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(**cfg), values=a.data)
    tptr, tidx, tvals = tfmt.csr_transpose(a.indptr, a.indices, N, a.data)
    tpt = vt.csr_preprocess(tptr, tidx, N, vt.PlanConfig(**cfg), values=tvals)
    return a, jp, jpt, tp, tpt


def test_k4_op_opcheck_and_gradients_match_jax():
    a, jp, jpt, tp, tpt = weighted_pair(1)
    x, w = feats(2, N, 16), feats(3, N, 16)
    ops, geom = L.operands(tp, "spmm_weighted", CPU)
    ops_dv, geom_dv = L.operands(tp, "spmm_dvalues", CPU)
    ops_t, geom_t = L.operands(tpt, "spmm_weighted", CPU)
    values = tp.values.clone().requires_grad_(True)
    xt = t(x, grad=True)
    args = (xt, values, ops, geom, ops_dv, geom_dv, tpt.values, ops_t, geom_t)
    op_check(L.spmm_weighted_op, args)
    out = L.spmm_weighted_op(*args)
    assert torch.equal(out.detach(), spmm_weighted_reference(tp, t(x)))  # the plain version
    (out * t(w)).sum().backward()

    def jloss(xj, vj):
        return jnp.sum(jops.spmm_weighted_ad(dataclasses.replace(jp, values=vj), jpt, xj) * w)

    gx, gv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(jp.values))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jops.spmm_pallas_weighted(jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(values.grad.numpy(), np.asarray(gv), **TOL)
    # the feature gradient needs A^T's plane, and K5's operands that of values
    for args_off, match in (((xt, values, ops, geom, ops_dv, geom_dv, None, ops_t, geom_t),
                             "plan_t.values"),
                            ((t(x), values, ops, geom, *absent(ops, geom), None,
                              *absent(ops, geom)), "K5's operands")):
        with pytest.raises((ValueError, RuntimeError), match=match):
            L.spmm_weighted_op(*args_off).sum().backward()


def test_k5_op_opcheck_matches_jax():
    _, jp, _, tp, _ = weighted_pair(4)
    feat, g = feats(5, N, 12), feats(6, N, 12)
    ops, geom = L.operands(tp, "spmm_dvalues", CPU)
    op_check(L.spmm_dvalues_op, (t(feat), t(g), ops, geom))
    out = L.spmm_dvalues_op(t(feat), t(g), ops, geom)
    assert out.shape == (tp.total_blocks, 64, 128)
    assert torch.equal(out, spmm_weighted_dvalues_reference(tp, t(feat), t(g)))
    want = jops.spmm_weighted_dvalues(jp, jnp.asarray(feat), jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


# --- K6 and K7 -------------------------------------------------------------------------

def ell_pair(seed, cfg=dict(block_h=64)):
    a = graph(seed, weighted=True)
    jp, jpt = jfmt.build_ell_pair(a.indptr, a.indices, N, values=a.data,
                                  config=jfmt.PlanConfig(**cfg))
    tp, tpt = tfmt.build_ell_pair(a.indptr, a.indices, N, values=a.data,
                                  config=vt.PlanConfig(**cfg))
    return a, jp, jpt, tp, tpt


def test_k6_op_opcheck_and_gradients_match_jax():
    a, jp, jpt, tp, tpt = ell_pair(7)
    x, w = feats(8, N, 16), feats(9, N, 16)
    ops, geom = L.ell_operands(tp, "spmm_ell", CPU)
    ops_dv, geom_dv = L.ell_operands(tp, "spmm_ell_dvals", CPU)
    ops_t, geom_t = L.ell_operands(tpt, "spmm_ell", CPU)
    vals = tp.vals.clone().requires_grad_(True)
    xt = t(x, grad=True)
    args = (xt, vals, ops, geom, ops_dv, geom_dv, tpt.vals, ops_t, geom_t, False)
    op_check(L.spmm_ell_op, args)
    out = L.spmm_ell_op(*args)
    assert torch.equal(out.detach(), spmm_ell_reference(tp, t(x)))
    (out * t(w)).sum().backward()

    def jloss(xj, vj):
        return jnp.sum(jops.spmm_ell_ad(dataclasses.replace(jp, vals=vj), jpt, xj) * w)

    gx, gv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(jp.vals))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jops.spmm_ell(jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(gv), **TOL)
    # compute_dtype=bfloat16's op: the values rounded to bf16 in the body
    xb = t(x).to(torch.bfloat16)
    rounded = L.spmm_ell_op(xb, tp.vals, ops, geom, *absent(ops, geom), None,
                            *absent(ops, geom), True)
    want = spmm_ell_reference(dataclasses.replace(tp, vals=tp.vals.bfloat16().float()), xb,
                              torch.float32)
    assert torch.equal(rounded, want)


def test_k7_op_opcheck_and_sddmm_gradients_match_jax():
    a, jp, jpt, tp, tpt = ell_pair(10)
    x, y = feats(11, N, 16), feats(12, N, 16)
    coeff = feats(13, a.nnz)
    ops, geom = L.ell_operands(tp, "spmm_ell_dvals", CPU)
    ops_x, geom_x = L.ell_operands(tp, "spmm_ell", CPU)
    ops_t, geom_t = L.ell_operands(tpt, "spmm_ell", CPU)
    ops_t = [*ops_t, vt.ops.ell.ell_lane_map(tp, tpt)]
    xt, yt = t(x, grad=True), t(y, grad=True)
    args = (yt, xt, ops, geom, ops_x, geom_x, ops_t, geom_t)  # feat = y, g = x
    op_check(L.spmm_ell_dvals_op, args)
    lanes = L.spmm_ell_dvals_op(*args)
    assert torch.equal(lanes.detach(), spmm_ell_dvals_reference(tp, t(y), t(x)))
    e = tfmt.edge_values(tp, lanes)  # the gather stays outside the op
    (torch.tanh(e) * t(coeff)).sum().backward()

    def jloss(xj, yj):
        return jnp.sum(jnp.tanh(jops.sddmm_ell_ad(jp, jpt, xj, yj)) * coeff)

    wx, wy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(
        lanes.detach().numpy(),
        np.asarray(jops.spmm_ell_dvals(jp, jnp.asarray(y), jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wx), **TOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(wy), **TOL)
    # the lane map takes plan's lanes to plan_t's through each edge
    m = vt.ops.ell.ell_lane_map(tp, tpt)
    assert torch.equal(m[tpt.edge_lane.long()], tp.edge_lane.long())
    assert bool((m[tpt.lane_edge < 0] == -1).all())


# --- K8 --------------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 13], ids=["d16", "d13-padded"])
def test_k8_op_opcheck_matches_jax_and_has_no_gradient(d):
    a = graph(14)
    plan = vt.csr_preprocess(a.indptr, a.indices, N)
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, backend="numpy")
    x = feats(15, N, d)
    rows, scale = quant.quantize_padded(t(x))
    ops, geom = L.operands(plan, "spmm_int8", CPU)
    op_check(L.spmm_int8_op, (rows, scale, ops, geom, d))
    out = L.spmm_int8_op(rows, scale, ops, geom, d)
    assert torch.equal(out, quant.spmm_int8_reference(plan, t(x)))
    want = jops.spmm(jplan, jnp.asarray(x), impl="int8")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **INT8_TOL)
    with pytest.raises(RuntimeError, match="no gradient"):
        L.spmm_int8_op(rows, scale.clone().requires_grad_(True), ops, geom, d).sum().backward()


# --- K9-K15 ----------------------------------------------------------------------------

def attention_plans(seed, cfg=dict(block_h=128, block_w=128, block_unroll=2)):
    a = graph(seed, density=0.03)
    a.data[:] = 1.0
    at = a.T.tocsr()
    jp = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(**cfg))
    jpt = jfmt.csr_preprocess(at.indptr, at.indices, N, jfmt.PlanConfig(**cfg))
    tp = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(**cfg))
    tpt = vt.csr_preprocess(at.indptr, at.indices, N, vt.PlanConfig(**cfg))
    return jp, jpt, tp, tpt


@pytest.mark.parametrize("split", [True, False], ids=["k11-k12", "k10"])
def test_k9_op_opcheck_and_gradients_match_jax(split):
    jp, jpt, tp, tpt = attention_plans(16)
    q, k, v, w = feats(17, N, 8), feats(18, N, 8), feats(19, N, 12), feats(20, N, 12)
    scale, slope = 8 ** -0.5, 0.2
    ops, geom = L.operands(tp, "spmm_attention", CPU)
    if split:  # K11 over plan, K12 over plan_t
        bwd = (*L.operands(tp, "attention_dq", CPU), *L.operands(tpt, "attention_dkv", CPU))
    else:  # K10 with its fixed-order sum
        ops_b, geom_b = L.operands(tp, "attention_bwd", CPU)
        bwd = (ops_b, geom_b, *absent(ops, geom))
    qt, kt, vt_ = t(q, True), t(k, True), t(v, True)
    args = (qt, kt, vt_, ops, geom, *bwd, scale, slope)
    op_check(L.spmm_attention_op, args)
    out, lse = L.spmm_attention_op(*args)
    want, want_lse = spmm_attention_reference(tp, t(q), t(k), t(v), scale=scale,
                                              negative_slope=slope, return_stats=True)
    assert torch.equal(out.detach(), want) and torch.equal(lse, want_lse)
    assert not lse.requires_grad  # lse carries no gradient
    (out * t(w)).sum().backward()

    def jloss(qj, kj, vj):
        return jnp.sum(jax_attention_ad(jp, qj, kj, vj, plan_t=jpt if split else None,
                                        scale=scale, negative_slope=slope) * w)

    grads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jops.spmm_attention(
        jp, *map(jnp.asarray, (q, k, v)), scale=scale, negative_slope=slope)), **FWD_TOL)
    for got, want_g in zip((qt, kt, vt_), grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("summed", [True, False], ids=["summed", "lane-planes"])
def test_k10_op_opcheck(summed):
    _, _, tp, _ = attention_plans(21)
    q, k, v, g = (t(feats(22 + i, N, 8)) for i in range(4))
    out, lse = spmm_attention_reference(tp, q, k, v, return_stats=True)
    ops, geom = L.operands(tp, "attention_bwd", CPU)
    args = (q, k, v, out, lse, g, ops, geom, 0.3, 1.0, summed)
    op_check(L.attention_bwd_op, args)
    got = L.attention_bwd_op(*args)
    dq, dk_lane, dv_lane = attention_bwd_reference(tp, q, k, v, out, lse, g, scale=0.3)
    if summed:
        src = plan_lane_sources(tp)
        dk_lane, dv_lane = (sum_slots_reference(src, p.index_select(0, src.slot_lane.long()), N)
                            for p in (dk_lane, dv_lane))
    for a_, b_ in zip(got, (dq, dk_lane, dv_lane)):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("heads", [1, 2], ids=["k11-k12", "k14-k15"])
def test_split_backward_ops_opcheck(heads):
    _, _, tp, tpt = attention_plans(26)
    q, k, v = (t(feats(27 + i, heads, N, 8)) for i in range(3))
    out, lse = spmm_attention_mh_reference(tp, q, k, v, return_stats=True)
    g = t(feats(30, heads, N, 8))
    d_row = (g * out).sum(-1)
    one = heads == 1
    dq_op = L.attention_dq_op if one else L.attention_mh_dq_op
    dkv_op = L.attention_dkv_op if one else L.attention_mh_dkv_op
    names = ("attention_dq", "attention_dkv") if one else ("attention_mh_dq", "attention_mh_dkv")
    dq_args = (q, k, v, g, lse, d_row, *L.operands(tp, names[0], CPU), 0.3, 0.2, None)
    dkv_args = (q, k, v, g, lse, d_row, *L.operands(tpt, names[1], CPU), 0.3, 0.2, None)
    op_check(dq_op, dq_args)
    op_check(dkv_op, dkv_args)
    dq, (dk, dv) = dq_op(*dq_args), dkv_op(*dkv_args)
    if one:
        views = [x[0] for x in (q, k, v, g, lse, d_row)]
        want_dq = attention_dq_reference(tp, *views, scale=0.3, negative_slope=0.2)[None]
        want_dk, want_dv = (x[None] for x in attention_dkv_reference(
            tpt, *views, scale=0.3, negative_slope=0.2))
    else:
        want_dq = attention_mh_dq_reference(tp, q, k, v, g, lse, d_row, scale=0.3,
                                            negative_slope=0.2)
        want_dk, want_dv = attention_mh_dkv_reference(tpt, q, k, v, g, lse, d_row, scale=0.3,
                                                      negative_slope=0.2)
    assert torch.equal(dq, want_dq) and torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


@pytest.mark.parametrize("plane", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k13_op_opcheck_and_gradients_match_jax(plane):
    jp, jpt, tp, tpt = attention_plans(31)
    heads = 2
    q, k, v, w = (feats(32 + i, heads, N, 8) for i in range(4))
    scale, slope = 8 ** -0.5, 0.2
    ops, geom = L.operands(tp, "spmm_attention_mh", CPU)
    bwd = (*L.operands(tp, "attention_mh_dq", CPU), *L.operands(tpt, "attention_mh_dkv", CPU))
    qt, kt, vt_ = t(q, True), t(k, True), t(v, True)
    args = (qt, kt, vt_, ops, geom, *bwd, scale, slope, plane)
    op_check(L.spmm_attention_mh_op, args)
    out, lse = L.spmm_attention_mh_op(*args)
    want, want_lse = spmm_attention_mh_reference(tp, t(q), t(k), t(v), scale=scale,
                                                 negative_slope=slope, plane_dtype=plane,
                                                 return_stats=True)
    assert torch.equal(out.detach(), want) and torch.equal(lse, want_lse)
    (out * t(w)).sum().backward()
    jplane = None if plane is None else jnp.bfloat16

    def jloss(qj, kj, vj):
        return jnp.sum(jax_mh_ad(jp, qj, kj, vj, plan_t=jpt, scale=scale, negative_slope=slope,
                                 plane_dtype=jplane) * w)

    grads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jops.spmm_attention_mh(
        jp, *map(jnp.asarray, (q, k, v)), scale=scale, negative_slope=slope,
        plane_dtype=jplane)), **FWD_TOL)
    for got, want_g in zip((qt, kt, vt_), grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want_g), **GRAD_TOL)


def test_every_kernel_is_an_op_with_a_flop_formula():
    """K1-K15 each have an op in the voltrix namespace (K11 and K12 their
    own, on K14's and K15's kernels), and the flop counter counts each:
    2 nnz d for the SpMMs, 2 nnz H (dk + dv) for the attention forwards."""
    from torch.utils.flop_counter import FlopCounterMode

    assert set(L.KINDS) == set(L.LOADERS)
    for name in L.KINDS:
        assert hasattr(torch.ops.voltrix, name), name
    _, _, tp, _ = attention_plans(36)
    q = t(feats(37, 2, N, 8))
    with FlopCounterMode(display=False) as counter:
        vt.ops.spmm_attention_mh(tp, q, q, q)
    assert counter.get_total_flops() == 2 * tp.num_edges * 2 * (8 + 8)


def test_operands_follow_the_piece_limits(monkeypatch):
    """The operands are kept beside the plan under the kernel's piece
    limits, as its work list is: a sweep that moves a limit gets operands
    (on the card, a work list) of its own, and the default's come back."""
    from voltrix_spmm_tpu_torch.ops import block_spmm, ell

    _, _, tp, _ = attention_plans(38)
    first = L.operands(tp, "spmm_attention", CPU)
    assert L.operands(tp, "spmm_attention", CPU) is first
    monkeypatch.setitem(block_spmm.PIECE_BLOCKS, "spmm_attention", 8)
    assert L.operands(tp, "spmm_attention", CPU) is not first
    monkeypatch.undo()
    assert L.operands(tp, "spmm_attention", CPU) is first
    _, _, _, ep, _ = ell_pair(39)
    rows = L.ell_operands(ep, "spmm_ell", CPU)
    monkeypatch.setattr(ell, "PIECE_LANES", 5)
    assert L.ell_operands(ep, "spmm_ell", CPU) is not rows


def test_operands_are_freed_with_their_plan():
    """The kept operands hold the plan's arrays, never their anchor, so a
    plan whose last reference goes frees them all, the ELL plans and the
    attention plans included (the tuner checks that a raced candidate
    leaves nothing allocated on the card)."""
    import gc
    import weakref

    a, _, _, tp, tpt = ell_pair(40)
    x = t(feats(41, N, 4), grad=True)
    vt.spmm_ell_ad(dataclasses.replace(tp, vals=tp.vals.clone().requires_grad_(True)), tpt,
                   x).sum().backward()
    vt.sddmm_ell_ad(tp, tpt, x, x).sum().backward()
    _, _, sp_plan, _ = attention_plans(42)
    vt.ops.spmm_attention_ad(sp_plan, x, x, x).sum().backward()  # K10
    vt.ops.spmm_attention_ad(sp_plan, x, x, x, plan_t=sp_plan).sum().backward()  # K11, K12
    refs = [weakref.ref(r) for r in (tp.erow, tp.hind, tpt.erow, tpt.lane_edge, sp_plan.bitmask,
                                      sp_plan.hind, sp_plan.block_ptr)]
    del tp, tpt, sp_plan
    gc.collect()
    assert not any(r() is not None for r in refs)

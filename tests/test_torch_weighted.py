"""Parity of the PyTorch port's weighted SpMM with the JAX package on the
CPU: weighted plans, `csr_transpose` and `edge_slot_map` bit for bit; the
plain versions of kernels K4 (`spmm_weighted`) and K5
(`spmm_weighted_dvalues`) against `spmm_pallas_weighted` and
`spmm_weighted_dvalues` in interpret mode; `sddmm`; the gradients of
`spmm_weighted_ad` against `jax.grad`; and K5's work list (each block's
plane written once, by the piece that holds it) with its edge cases
(block_w 256, bits on rows past num_nodes, clipped hind) against JAX.

The kernels run only on the card and are checked against the same plain
versions there by chip_smoke.py. SpMM outputs use tests/test_spmm.py:51-52's
tolerance (float32 sums in another order).
"""

import dataclasses
import os
import re
import stat
import sys

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
import voltrix_spmm_tpu_torch.jit.compiler as compiler
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.ops import (
    sddmm,
    spmm_reference,
    spmm_weighted,
    spmm_weighted_dvalues,
    spmm_weighted_dvalues_reference,
    spmm_weighted_reference,
)
from voltrix_spmm_tpu_torch.ops.block_spmm import PIECE_BLOCKS, PIECE_WORK, plan_walk
from voltrix_spmm_tpu_torch.ops.weighted import _SMEM_LIMIT, _check_kernel_args, k4_tiling

TOL = dict(rtol=1e-5, atol=1e-4)


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
    rows kept sorted: duplicates must sum."""
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


def both_weighted(indptr, indices, values, n, num_cols=None, **cfg):
    jplan = jfmt.csr_preprocess(indptr, indices, n, jfmt.PlanConfig(**cfg), backend="numpy",
                                num_cols=num_cols, values=values)
    tplan = vt.csr_preprocess(indptr, indices, n, vt.PlanConfig(**cfg), num_cols=num_cols,
                              values=values)
    return jplan, tplan


def assert_close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    if out.size:
        assert vt.calc_diff(out, ref) < 1e-6
    np.testing.assert_allclose(out, ref, **tol)


def plan_case(case):
    """(indptr, indices, values, n, num_cols, cfg) of a named geometry."""
    if case == "duplicates":
        indptr, indices, values = with_duplicates(weighted_csr(400, 0.03, 1), seed=1)
        return indptr, indices, values, 400, None, dict(block_h=64)
    if case == "padded_empty_windows":
        a = drop_rows(weighted_csr(2048, 0.01, 2), lambda r: not 256 <= r < 512)
        return a.indptr, a.indices, a.data, 2048, None, dict(block_h=128)
    if case == "left_empty_windows":
        a = drop_rows(weighted_csr(2048, 0.01, 3), lambda r: r < 32)
        return a.indptr, a.indices, a.data, 2048, None, dict(block_h=32, block_unroll=2)
    if case == "empty_matrix":
        a = weighted_csr(300, 0.0, 4)
        return a.indptr, a.indices, a.data, 300, None, dict(block_h=64)
    if case == "unroll2":
        a = weighted_csr(700, 0.03, 5)
        return a.indptr, a.indices, a.data, 700, None, dict(block_h=64, block_unroll=2)
    if case == "rectangular":
        a = weighted_csr(500, 0.02, 6, num_cols=900)
        return a.indptr, a.indices, a.data, 500, 900, dict(block_h=64)
    assert case == "block_w256"
    a = weighted_csr(600, 0.02, 7)
    return a.indptr, a.indices, a.data, 600, None, dict(block_h=32, block_w=256)


CASES = ["duplicates", "padded_empty_windows", "left_empty_windows", "empty_matrix",
         "unroll2", "rectangular", "block_w256"]


@pytest.mark.parametrize("case", CASES)
def test_weighted_plan_bit_identical(case):
    indptr, indices, values, n, num_cols, cfg = plan_case(case)
    jplan, tplan = both_weighted(indptr, indices, values, n, num_cols, **cfg)
    np.testing.assert_array_equal(tplan.bitmask.numpy().view(np.uint32), jplan.bitmask)
    for name in ("hind", "window_of_block", "block_ptr"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)), err_msg=name)
    for name in ("num_edges", "num_windows", "total_blocks", "has_empty_windows"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    c = tplan.config
    assert tplan.values.dtype == torch.float32
    assert tuple(tplan.values.shape) == (tplan.total_blocks, c.block_h, c.block_w)
    if jplan.values is None:  # the JAX package leaves the empty matrix's plane out
        assert tplan.total_blocks == 0
    else:
        # bit for bit: duplicates summed in the same np.add.at order
        np.testing.assert_array_equal(tplan.values.numpy().view(np.uint32),
                                      np.asarray(jplan.values).view(np.uint32))
    if case == "duplicates":
        assert tplan.num_edges < indices.shape[0]


def test_weighted_plan_rejects_bad_values():
    a = weighted_csr(256, 0.05, 8)
    with pytest.raises(ValueError, match="align"):
        vt.csr_preprocess(a.indptr, a.indices, 256, vt.PlanConfig(64, 128), values=a.data[:-1])
    with pytest.raises(ValueError, match="block_h % 32"):
        vt.csr_preprocess(a.indptr, a.indices, 256, vt.PlanConfig(48, 128), values=a.data)


@pytest.mark.parametrize("num_cols,with_values", [(None, True), (None, False), (900, True)])
def test_csr_transpose_bit_identical(num_cols, with_values):
    n = 500
    indptr, indices, values = with_duplicates(weighted_csr(n, 0.02, 9, num_cols=num_cols), 9)
    vals = values if with_values else None
    got = tfmt.csr_transpose(indptr, indices, n, vals, num_cols=num_cols)
    want = jfmt.csr_transpose(indptr, indices, n, vals, num_cols=num_cols)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if with_values:
        np.testing.assert_array_equal(got[2].view(np.uint32), want[2].view(np.uint32))
    else:
        assert got[2] is None and want[2] is None


@pytest.mark.parametrize("case", CASES)
def test_edge_slot_map_bit_identical(case):
    indptr, indices, values, n, num_cols, cfg = plan_case(case)
    jplan, tplan = both_weighted(indptr, indices, values, n, num_cols, **cfg)
    slots = tfmt.edge_slot_map(tplan, indptr, indices)
    np.testing.assert_array_equal(slots, jfmt.edge_slot_map(jplan, indptr, indices))
    # scattering the CSR values through the slots rebuilds the plane
    plane = torch.zeros(tplan.values.numel()).index_add_(
        0, torch.from_numpy(slots), torch.from_numpy(np.asarray(values, np.float32)))
    np.testing.assert_allclose(plane.view_as(tplan.values).numpy(), tplan.values.numpy(),
                               rtol=1e-6)


def test_edge_slot_map_raises_on_a_plan_of_another_csr():
    a, b = weighted_csr(300, 0.03, 10), weighted_csr(300, 0.03, 11)
    plan = vt.csr_preprocess(a.indptr, a.indices, 300, vt.PlanConfig(64, 128))
    with pytest.raises(ValueError, match="not represented"):
        tfmt.edge_slot_map(plan, b.indptr, b.indices)
    seg = vt.csr_preprocess(a.indptr, a.indices, 300, vt.PlanConfig(64, 128, gather_segment=4))
    with pytest.raises(ValueError, match="exact-lane"):
        tfmt.edge_slot_map(seg, a.indptr, a.indices)


@pytest.mark.parametrize("d", [8, 40, 100, 300])
@pytest.mark.parametrize("cfg", [dict(block_h=64), dict(block_h=32, block_unroll=2)])
def test_spmm_weighted_matches_jax(d, cfg):
    n = 500
    a = weighted_csr(n, 0.03, seed=d)
    jplan, tplan = both_weighted(a.indptr, a.indices, a.data, n, **cfg)
    # a value placed off the bitmask counts, in both packages
    word0 = tplan.bitmask.numpy()[0, 0]  # rows 0-31 of block 0
    lane = np.nonzero(((word0 >> 5) & 1) == 0)[0][0]
    off = np.array(jplan.values)
    off[0, 5, lane] = -1.5  # row 5 has no edge in this lane
    tplan = dataclasses.replace(tplan, values=torch.from_numpy(off.copy()))
    jplan = dataclasses.replace(jplan, values=off)
    x = features(n, d, seed=1)
    ref = np.asarray(jops.spmm_pallas_weighted(jplan, jnp.asarray(x)))
    calls = spmm_weighted_reference.calls
    out = vt.spmm(tplan, torch.from_numpy(x))
    assert spmm_weighted_reference.calls == calls + 1  # "auto" -> K4's wrapper -> plain on CPU
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, d)
    assert_close(out, ref)
    dense = a.toarray()  # the value off the bitmask changes the result
    assert not np.allclose(out.numpy(), dense @ x, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["duplicates", "padded_empty_windows", "left_empty_windows",
                                  "empty_matrix", "rectangular", "block_w256"])
def test_spmm_weighted_edge_cases_match_jax(case):
    indptr, indices, values, n, num_cols, cfg = plan_case(case)
    jplan, tplan = both_weighted(indptr, indices, values, n, num_cols, **cfg)
    x = features(num_cols or n, 24, seed=2)
    out = spmm_weighted(tplan, torch.from_numpy(x))
    ref = jops.spmm(jplan, jnp.asarray(x))  # impl="auto" (binary for JAX's empty plan)
    assert_close(out, np.asarray(ref))
    want = sp.csr_matrix((values, indices, indptr), shape=(n, num_cols or n)) @ x
    assert_close(out, want)
    if case == "left_empty_windows":
        assert tplan.has_empty_windows and not out[32:].any()


def test_spmm_weighted_out_dtype_and_dispatch():
    n, d = 300, 16
    a = weighted_csr(n, 0.05, 12)
    _, tplan = both_weighted(a.indptr, a.indices, a.data, n, block_h=64)
    x = torch.from_numpy(features(n, d, seed=3))
    full = vt.spmm(tplan, x)
    out = vt.spmm(tplan, x, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, full.to(torch.bfloat16))
    # "reference" runs K4's plain version, never the binary oracle
    calls, binary = spmm_weighted_reference.calls, spmm_reference.calls
    assert torch.equal(vt.spmm(tplan, x, impl="reference"), full)
    assert torch.equal(vt.spmm(tplan, x, impl="weighted"), full)
    assert (spmm_weighted_reference.calls - calls, spmm_reference.calls - binary) == (2, 0)
    # the binary kernels refuse a value plane, as the JAX kernels do
    for impl in ("pregather", "pallas"):
        with pytest.raises(ValueError, match="value plane"):
            vt.spmm(tplan, x, impl=impl)
    with pytest.raises(ValueError, match="value plane"):
        vt.spmm_ad(tplan, tplan, x)
    binary_plan = dataclasses.replace(tplan, values=None)
    with pytest.raises(ValueError, match="no value plane"):
        vt.spmm(binary_plan, x, impl="weighted")
    xb = torch.from_numpy(np.random.default_rng(4).standard_normal((2, n, d)).astype(np.float32))
    outb = vt.spmm(tplan, xb)
    assert torch.allclose(outb[1], vt.spmm(tplan, xb[1].contiguous()), **TOL)


def test_spmm_weighted_values_chunks_are_bit_equal():
    n, d = 700, 40
    a = weighted_csr(n, 0.03, 13)
    _, tplan = both_weighted(a.indptr, a.indices, a.data, n, block_h=64)
    x = torch.from_numpy(features(n, d, seed=5))
    one = spmm_weighted_reference(tplan, x)
    small = spmm_weighted_reference(tplan, x, chunk_bytes=1)  # one block per chunk
    assert torch.equal(one, small)
    g = torch.from_numpy(features(n, d, seed=6))
    assert torch.equal(spmm_weighted_dvalues_reference(tplan, x, g),
                       spmm_weighted_dvalues_reference(tplan, x, g, chunk_bytes=1))


def dvalues_numpy(plan, feat, g):
    """dV[b, r, l] = g[w*H + r] . feat[hind[b, l]] on set bits, in float64."""
    cfg = plan.config
    H = cfg.block_h
    bits = tfmt.expand_bitmask_np(plan.bitmask, H).astype(bool)
    hind = plan.hind.numpy()
    wob = plan.window_of_block.numpy()
    g_pad = np.zeros((plan.padded_nodes, feat.shape[1]))
    g_pad[: plan.num_nodes] = g
    want = np.einsum("brd,bld->brl", g_pad.reshape(plan.num_windows, H, -1)[wob],
                     feat.astype(np.float64)[np.clip(hind, 0, feat.shape[0] - 1)])
    return np.where(bits, want, 0.0), bits


@pytest.mark.parametrize("d", [8, 40, 100])
@pytest.mark.parametrize("case", ["duplicates", "unroll2", "padded_empty_windows",
                                  "left_empty_windows", "rectangular"])
def test_dvalues_matches_jax(d, case):
    indptr, indices, values, n, num_cols, cfg = plan_case(case)
    jplan, tplan = both_weighted(indptr, indices, values, n, num_cols, **cfg)
    feat = features(num_cols or n, d, seed=7)
    g = features(n, d, seed=8)
    ref = np.asarray(jops.spmm_weighted_dvalues(jplan, jnp.asarray(feat), jnp.asarray(g)))
    out = spmm_weighted_dvalues(tplan, torch.from_numpy(feat), torch.from_numpy(g))
    assert_close(out, ref)
    want, bits = dvalues_numpy(tplan, feat, g)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    assert (out.numpy()[~bits] == 0.0).all()  # exactly zero off the bitmask


def test_dvalues_empty_matrix_and_checks():
    n = 300
    a = weighted_csr(n, 0.0, 14)
    _, tplan = both_weighted(a.indptr, a.indices, a.data, n, block_h=64)
    out = spmm_weighted_dvalues(tplan, torch.zeros(n, 8), torch.zeros(n, 8))
    assert tuple(out.shape) == (0, 64, 128)
    b = weighted_csr(n, 0.05, 15)
    _, tplan = both_weighted(b.indptr, b.indices, b.data, n, block_h=64)
    with pytest.raises(ValueError, match="g must be"):
        spmm_weighted_dvalues(tplan, torch.zeros(n, 8), torch.zeros(n, 9))
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm_weighted_dvalues(tplan.to("meta"), torch.zeros(n, 8, device="meta"),
                              torch.zeros(n, 8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm_weighted(tplan.to("meta"), torch.zeros(n, 8, device="meta"))


def test_sddmm_matches_jax():
    n, d = 300, 48
    a = weighted_csr(n, 0.04, 16)
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, n, jfmt.PlanConfig(64, 128),
                                backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(64, 128))
    x, y = features(n, d, seed=9), features(n, d, seed=10)
    slots = tfmt.edge_slot_map(tplan, a.indptr, a.indices)
    per_edge = sddmm(tplan, torch.from_numpy(x), torch.from_numpy(y),
                     per_edge=torch.from_numpy(slots))
    ref = jops.sddmm(jplan, jnp.asarray(x), jnp.asarray(y), per_edge=jnp.asarray(slots))
    np.testing.assert_allclose(per_edge.numpy(), np.asarray(ref), **TOL)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    np.testing.assert_allclose(per_edge.numpy(), np.sum(x[rows] * y[a.indices], axis=1), **TOL)
    plane = sddmm(tplan, torch.from_numpy(x), torch.from_numpy(y))
    assert_close(plane, np.asarray(jops.sddmm(jplan, jnp.asarray(x), jnp.asarray(y))))
    # the plane feeds straight back into a weighted SpMM
    out = vt.spmm(dataclasses.replace(tplan, values=plane), torch.from_numpy(y))
    sc = sp.csr_matrix((np.sum(x[rows] * y[a.indices], axis=1), a.indices, a.indptr),
                       shape=(n, n))
    np.testing.assert_allclose(out.numpy(), sc @ y, rtol=1e-4, atol=1e-3)


def weighted_plans(a, n, cfg):
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, n, jfmt.PlanConfig(**cfg),
                                backend="numpy", values=a.data)
    ptr_t, idx_t, vals_t = jfmt.csr_transpose(a.indptr, a.indices, n, a.data)
    jplan_t = jfmt.csr_preprocess(ptr_t, idx_t, n, jfmt.PlanConfig(**cfg), backend="numpy",
                                  values=vals_t)
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg), values=a.data)
    tptr, tidx, tvals = tfmt.csr_transpose(a.indptr, a.indices, n, a.data)
    tplan_t = vt.csr_preprocess(tptr, tidx, n, vt.PlanConfig(**cfg), values=tvals)
    return jplan, jplan_t, tplan, tplan_t


@pytest.mark.parametrize("cfg", [dict(block_h=64), dict(block_h=32, block_unroll=2)])
def test_spmm_weighted_ad_gradients_match_jax(cfg):
    n, d = 260, 40
    a = weighted_csr(n, 0.04, 17)
    jplan, jplan_t, tplan, tplan_t = weighted_plans(a, n, cfg)
    x, w = features(n, d, seed=11), features(n, d, seed=12)

    def jloss(xj, values):
        return jnp.sum(jops.spmm_weighted_ad(dataclasses.replace(jplan, values=values),
                                             jplan_t, xj) * w)

    gx, gv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(jplan.values))
    xt = torch.from_numpy(x).requires_grad_(True)
    vals = tplan.values.clone().requires_grad_(True)
    planv = dataclasses.replace(tplan, values=vals)
    k4, k5 = spmm_weighted_reference.calls, spmm_weighted_dvalues_reference.calls
    out = vt.spmm_weighted_ad(planv, tplan_t, xt)
    (out * torch.from_numpy(w)).sum().backward()
    # forward, dfeat over plan_t, dvalues: two K4 and one K5 (plain here)
    assert (spmm_weighted_reference.calls - k4, spmm_weighted_dvalues_reference.calls - k5) == (2, 1)
    assert_close(out.detach(), a @ x)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), a.T @ w, **TOL)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(gv), **TOL)


def test_spmm_weighted_ad_launches_only_the_sides_needed():
    n, d = 200, 16
    a = weighted_csr(n, 0.05, 18)
    _, _, tplan, tplan_t = weighted_plans(a, n, dict(block_h=64))
    w = torch.from_numpy(features(n, d, seed=13))
    x = torch.from_numpy(features(n, d, seed=14))
    vals = tplan.values.clone().requires_grad_(True)
    k4, k5 = spmm_weighted_reference.calls, spmm_weighted_dvalues_reference.calls
    # values only: no feature gradient, so plan_t's plane is never read
    out = vt.spmm_weighted_ad(dataclasses.replace(tplan, values=vals),
                              dataclasses.replace(tplan_t, values=None), x)
    (out * w).sum().backward()
    assert (spmm_weighted_reference.calls - k4, spmm_weighted_dvalues_reference.calls - k5) == (1, 1)
    assert vals.grad is not None
    # feat only: no K5
    xt = x.clone().requires_grad_(True)
    k4, k5 = spmm_weighted_reference.calls, spmm_weighted_dvalues_reference.calls
    (vt.spmm_weighted_ad(tplan, tplan_t, xt) * w).sum().backward()
    assert (spmm_weighted_reference.calls - k4, spmm_weighted_dvalues_reference.calls - k5) == (2, 0)
    with pytest.raises(ValueError, match="unknown impl"):
        vt.spmm_weighted_ad(tplan, tplan_t, x, impl="pregather")


def test_learned_edge_weights_match_jax():
    """Per-edge parameters -> plane scatter through edge_slot_map -> the
    weighted SpMM: the gradient in the edge parameters as jax.grad has it."""
    n, d = 200, 32
    a = weighted_csr(n, 0.03, 19)
    jplan, jplan_t, tplan, tplan_t = weighted_plans(a, n, dict(block_h=64))
    slots = tfmt.edge_slot_map(tplan, a.indptr, a.indices)
    x, g = features(n, d, seed=15), features(n, d, seed=16)
    size = tplan.values.numel()
    shape = tuple(tplan.values.shape)

    def jloss(w):
        plane = jnp.zeros(size, jnp.float32).at[jnp.asarray(slots)].add(w).reshape(shape)
        return jnp.sum(jops.spmm_weighted_ad(dataclasses.replace(jplan, values=plane),
                                             jplan_t, jnp.asarray(x)) * g)

    w0 = a.data.astype(np.float32)
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(w0)))
    wt = torch.from_numpy(w0.copy()).requires_grad_(True)
    plane = torch.zeros(size).index_add_(0, torch.from_numpy(slots), wt).view(shape)
    out = vt.spmm_weighted_ad(dataclasses.replace(tplan, values=plane), tplan_t,
                              torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), ref, **TOL)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    np.testing.assert_allclose(wt.grad.numpy(), np.sum(g[rows] * x[a.indices], axis=1), **TOL)
    assert_close(out.detach(), a @ x)


@pytest.mark.parametrize("block_h,block_w,d,tiling", [
    (64, 128, 8, (8, 2, 1)), (64, 128, 40, (40, 4, 1)), (64, 128, 300, (60, 4, 5)),
    (32, 128, 3, (4, 2, 1)), (96, 128, 40, (40, 4, 1)), (128, 128, 40, (40, 8, 1)),
    (256, 128, 100, (52, 8, 2)), (128, 256, 64, (64, 8, 1)), (416, 128, 8, (8, 2, 1)),
    (512, 128, 8, (8, 2, 1)), (2048, 256, 130, (44, 8, 3)),
])
def test_k4_tiling(block_h, block_w, d, tiling):
    """K4's chunks of dc columns cover d, dc a multiple of 4 up to 64; a
    group's rows (at most 128) x dc / 4 quads fit 256 threads at tr rows a
    thread; its 3-stage ring (csrc/spmm_weighted.cu kStages) of value rows
    (36 floats apart) and feature rows fits shared memory at every
    block_h, the tall tiles the old kernel refused too."""
    dc, tr, chunks = k4_tiling(block_h, block_w, d)
    assert (dc, tr, chunks) == tiling
    rows = min(block_h, 128)
    assert dc % 4 == 0 and dc <= 64 and (chunks - 1) * dc < d <= chunks * dc
    assert rows % tr == 0 and rows // tr * dc // 4 <= 256
    assert 3 * 4 * (rows * 36 + 32 * dc) <= _SMEM_LIMIT


@pytest.mark.parametrize("block_h,block_w,d,match", [
    (48, 128, 8, "multiples of 32"), (64, 100, 8, "multiples of 32"),
    (64, 128, 64 * 65536, "grid limits"),
])
def test_k4_refuses_what_it_does_not_take(block_h, block_w, d, match):
    """K4's limits: whole 32-row bitmask words and 32-lane slices, and at
    most 65,535 column chunks."""
    with pytest.raises(ValueError, match=match):
        k4_tiling(block_h, block_w, d)


def test_kernel_arguments_are_checked():
    n = 300
    a = weighted_csr(n, 0.05, 20)
    _, tplan = both_weighted(a.indptr, a.indices, a.data, n, block_h=64)
    c = tplan.config
    fields = {"values": (torch.float32, (tplan.total_blocks, c.block_h, c.block_w)),
              "hind": (torch.int32, (tplan.total_blocks, c.block_w))}
    x = torch.zeros(n, 8)
    _check_kernel_args(tplan, "k", fields, x)  # a well-formed call passes
    with pytest.raises(TypeError, match="float32"):
        _check_kernel_args(tplan, "k", fields, x.double())
    with pytest.raises(TypeError, match="contiguous"):
        _check_kernel_args(tplan, "k", fields, torch.zeros(8, n).t())
    with pytest.raises(ValueError, match="SpmmPlan.to"):
        _check_kernel_args(tplan.to("meta"), "k", fields, x)
    with pytest.raises(ValueError, match="float32"):
        _check_kernel_args(dataclasses.replace(tplan, values=tplan.values.double()), "k",
                           fields, x)
    with pytest.raises(ValueError, match="is None"):
        _check_kernel_args(dataclasses.replace(tplan, values=None), "k", fields, x)


# --- K5: its work list and its edge cases -------------------------------------

def k5_walk(plan, piece_blocks):
    """plan_walk(plan, "spmm_dvalues") at `piece_blocks` (restored after)."""
    saved = PIECE_BLOCKS["spmm_dvalues"]
    try:
        PIECE_BLOCKS["spmm_dvalues"] = piece_blocks
        return plan_walk(plan, "spmm_dvalues")
    finally:
        PIECE_BLOCKS["spmm_dvalues"] = saved


def emulate_k5(plan, feat, g, piece_blocks):
    """K5's order in plain torch: for each piece of its work list, in task
    order, the plane rows of the piece's 128-row group on the piece's
    blocks, from the plain version on those blocks alone. Returns the plane
    (NaN where nothing wrote) and how often each (block, row) was written."""
    cfg = plan.config
    h = cfg.block_h
    out = torch.full((plan.total_blocks, h, cfg.block_w), float("nan"))
    writes = torch.zeros(plan.total_blocks, h, dtype=torch.int64)
    for _, grp, b0, b1, _, _ in k5_walk(plan, piece_blocks).tasks.tolist():
        sub = dataclasses.replace(plan, bitmask=plan.bitmask[b0:b1], hind=plan.hind[b0:b1],
                                  window_of_block=plan.window_of_block[b0:b1],
                                  total_blocks=b1 - b0, values=None)
        rows = slice(128 * grp, min(128 * grp + 128, h))
        out[b0:b1, rows] = spmm_weighted_dvalues_reference(sub, feat, g)[:, rows]
        writes[b0:b1, rows] += 1
    return out, writes


K5_CASES = [  # (config, piece_blocks, d)
    (dict(block_h=64, block_w=128), 1, 40),
    (dict(block_h=64, block_w=128), 8, 8),
    (dict(block_h=32, block_w=256), 3, 40),
    (dict(block_h=96, block_w=128), 2, 24),   # three words: one a warp
    (dict(block_h=256, block_w=128), 4, 100),  # two 128-row groups, two column chunks
]


@pytest.mark.parametrize("cfg,piece_blocks,d", K5_CASES)
def test_k5_work_list_writes_each_block_once(cfg, piece_blocks, d):
    """K5's pieces cover each 128-row group's blocks once, in order, at most
    PIECE_BLOCKS["spmm_dvalues"] a piece, with no work limit; written piece
    by piece, every plane row of every block is written exactly once, the
    plane agrees with JAX's spmm_weighted_dvalues in interpret mode, and
    it is exactly 0.0 off the bitmask."""
    a = symmetrize(chung_lu_csr(1500, 15000, seed=3))
    n = a.shape[0]
    vals = np.random.default_rng(11).standard_normal(a.nnz).astype(np.float32)
    jplan, tplan = both_weighted(a.indptr, a.indices, vals, n, **cfg)
    walk = k5_walk(tplan, piece_blocks)
    assert PIECE_WORK["spmm_dvalues"] is None  # a block limit alone
    bp = tplan.block_ptr.numpy()
    tasks = walk.tasks.numpy()
    for w in range(tplan.num_windows):
        for grp in range(-(-tplan.config.words_per_col // 4)):
            mine = tasks[(tasks[:, 0] == w) & (tasks[:, 1] == grp)]
            mine = mine[np.argsort(mine[:, 4])]
            assert mine[0, 2] == bp[w] and mine[-1, 3] == bp[w + 1]
            assert np.array_equal(mine[1:, 2], mine[:-1, 3])
            assert np.all(mine[:, 3] - mine[:, 2] <= piece_blocks)
    assert np.sum(tasks[:, 0] == 0) >= 2  # the hub window is cut
    feat, g = features(n, d, seed=12), features(n, d, seed=13)
    out, writes = emulate_k5(tplan, torch.from_numpy(feat), torch.from_numpy(g), piece_blocks)
    assert (writes == 1).all()
    ref = np.asarray(jops.spmm_weighted_dvalues(jplan, jnp.asarray(feat), jnp.asarray(g)))
    assert_close(out, ref)
    _, bits = dvalues_numpy(tplan, feat, g)
    assert (out.numpy()[~bits] == 0.0).all()


def _edit_plans(jplan, tplan, bitmask=None, hind=None):
    """Both plans with the same bitmask and hind put in."""
    fields = {k: v for k, v in (("bitmask", bitmask), ("hind", hind)) if v is not None}
    return (dataclasses.replace(jplan, **{k: jnp.asarray(v) for k, v in fields.items()}),
            dataclasses.replace(tplan, **{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.mark.parametrize("case", ["block_w256", "rows_past_n", "clipped_hind"])
def test_dvalues_edge_cases_match_jax(case):
    """K5's plain version against JAX on what K5 must take: block_w 256,
    bits on rows at num_nodes and beyond (g is zero there, so the plane
    is 0.0), and lanes with bits whose hind lies outside [0, source_rows)
    (clipped, as jnp.take(mode="clip") clips)."""
    if case == "block_w256":
        indptr, indices, values, n, _, cfg = plan_case("block_w256")
    else:
        a = weighted_csr(300, 0.03, 21)  # 300 rows: the last 64-row window ends at 320
        indptr, indices, values, n, cfg = a.indptr, a.indices, a.data, 300, dict(block_h=64)
    jplan, tplan = both_weighted(indptr, indices, values, n, **cfg)
    bitmask, hind = tplan.bitmask.numpy().copy(), tplan.hind.numpy().copy()
    last = tplan.window_of_block.numpy() == tplan.num_windows - 1
    if case == "rows_past_n":  # rows 300..319: bits 12..31 of the last window's word 1
        bitmask[last, 1, :] |= np.int32(np.uint32(0xFFFFF000).view(np.int32))
        jplan, tplan = _edit_plans(jplan, tplan, bitmask=bitmask)
    if case == "clipped_hind":
        held = np.flatnonzero((bitmask != 0).any(1).reshape(-1))
        flat = hind.reshape(-1)
        flat[held[::5]], flat[held[2::5]] = n + 7, -3
        jplan, tplan = _edit_plans(jplan, tplan, hind=hind)
    d = 40
    feat, g = features(n, d, seed=22), features(n, d, seed=23)
    ref = np.asarray(jops.spmm_weighted_dvalues(jplan, jnp.asarray(feat), jnp.asarray(g)))
    out = spmm_weighted_dvalues(tplan, torch.from_numpy(feat), torch.from_numpy(g))
    assert_close(out, ref)
    want, bits = dvalues_numpy(tplan, feat, g)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    assert (out.numpy()[~bits] == 0.0).all()
    if case == "rows_past_n":
        past = out.numpy()[last][:, n % 64:]
        assert bits[last][:, n % 64:].any() and (past == 0.0).all()
    if case == "block_w256":
        assert tplan.config.block_w == 256


def test_k5_source_builds_for_sm90a(tmp_path, monkeypatch):
    """K5 builds from csrc/spmm_dvalues.cu with one nvcc for sm_90a, with
    csrc/ on the include path for the work list layout of
    csrc/spmm_walk.cuh, and calls no atomic: every value of the plane is
    written once."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "if '--version' in sys.argv:\n"
        "    print('fake nvcc 0.0'); sys.exit(0)\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv(vt.project.NVCC_FLAG, str(nvcc))
    monkeypatch.setenv(vt.project.BUILD_DIR_FLAG, str(tmp_path / "kernels"))
    monkeypatch.setattr(compiler, "runtime_cache", {})
    path = compiler.build("spmm_dvalues", ["spmm_dvalues.cu"]).path
    assert os.path.basename(path) == "libspmm_dvalues.so"
    with open(os.path.join(compiler.CSRC_DIR, "spmm_dvalues.cu")) as f:
        text = f.read()
    assert '#include "spmm_walk.cuh"' in text
    assert not re.search(r"\batomic\w*\s*\(", text)
    (cmd,) = [line.split() for line in log.read_text().splitlines()]
    assert cmd[-1] == os.path.join(compiler.CSRC_DIR, "spmm_dvalues.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd and f"-I{compiler.CSRC_DIR}" in cmd

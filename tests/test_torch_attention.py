"""Parity of the PyTorch port's single-head fused attention
(voltrix_spmm_tpu_torch/ops/attention.py) with the JAX package on the CPU.

The same numpy graph and q, k, v go through both packages. The port runs
the plain versions of kernels K9, K10, K11 and K12 on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_attention.py
does. Tolerances are JAX's own for each op: the forward and lse at rtol
2e-4 / atol 2e-5 (tests/test_attention.py:76-78), gradients at rtol 2e-3 /
atol 2e-4 (:178-181), and the two backwards against each other at rtol
1e-4 / atol 1e-5 (:310-313).
"""

import dataclasses
import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.jit.compiler as compiler
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.format import csr_preprocess as jax_csr_preprocess
from voltrix_spmm_tpu.ops import spmm_attention as jax_attention
from voltrix_spmm_tpu.ops import spmm_attention_ad as jax_attention_ad
from voltrix_spmm_tpu.ops.attention import _attn_bwd as jax_attn_bwd
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.ops import (
    attention_bwd,
    attention_bwd_reference,
    attention_bwd_summed,
    attention_dkv,
    attention_dkv_reference,
    attention_dq,
    attention_dq_reference,
    scatter_lanes,
    spmm_attention,
    spmm_attention_ad,
    spmm_attention_mh_reference,
    spmm_attention_reference,
)
from voltrix_spmm_tpu_torch.ops._attn_core import _act, _edges
from voltrix_spmm_tpu_torch.ops.attention import (
    attention_walk,
    lane_source_order,
    plan_lane_sources,
    sum_slots_reference,
)
from voltrix_spmm_tpu_torch.ops.block_spmm import PIECE_BLOCKS, PIECE_WORK

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
PAIR_TOL = dict(rtol=1e-4, atol=1e-5)
GEOMETRIES = {  # tests/test_attention.py:55-63
    "h32": dict(block_h=32, block_w=128),
    "h128u2": dict(block_h=128, block_w=128, block_unroll=2),
    "h256cluster": dict(block_h=256, block_w=128, cluster_cols=True),
    "h128seg2": dict(block_h=128, block_w=128, gather_segment=2),
}


def random_graph(seed, n=260, density=0.03, empty_tail=0, symmetric=True):
    """tests/test_attention.py:random_graph from a numpy seed: symmetric
    unless asked otherwise; with empty_tail, the last rows and their
    columns emptied (whole empty windows at the tail)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    a.data[:] = 1.0
    if symmetric:
        a = ((a + a.T) != 0).astype(np.float32).tocsr()
    if empty_tail:
        keep = sp.diags(np.r_[np.ones(n - empty_tail), np.zeros(empty_tail)])
        a = (keep @ a @ keep).tocsr()
        a.eliminate_zeros()
    a.sort_indices()
    return a


def plans(a, cfg, cfg_t=None):
    """((JAX plan, JAX plan_t), (port plan, port plan_t)) of A and A^T."""
    n = a.shape[0]
    at = a.T.tocsr()
    cfg_t = cfg_t or cfg
    return ((jax_csr_preprocess(a.indptr, a.indices, n, JaxPlanConfig(**cfg)),
             jax_csr_preprocess(at.indptr, at.indices, n, JaxPlanConfig(**cfg_t))),
            (vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg)),
             vt.csr_preprocess(at.indptr, at.indices, n, vt.PlanConfig(**cfg_t))))


def qkv(n, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((n, dk), (n, dk), (n, dv)))


def calls():
    return (spmm_attention_reference.calls, attention_bwd_reference.calls,
            attention_dq_reference.calls, attention_dkv_reference.calls)


def since(before):
    return tuple(a - b for a, b in zip(calls(), before))


@pytest.mark.parametrize("slope", [1.0, 0.2], ids=["ident", "leaky"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_forward_and_lse_match_jax(geometry, slope):
    a = random_graph(seed=1)
    n, dk, dv = a.shape[0], 24, 40
    (jp, _), (tp, _) = plans(a, GEOMETRIES[geometry])
    q, k, v = qkv(n, dk, dv, seed=2)
    scale = 1.0 / dk ** 0.5
    want, want_lse = jax_attention(jp, *map(jnp.asarray, (q, k, v)), scale=scale,
                                   negative_slope=slope, return_stats=True)
    before = calls()
    got, lse = spmm_attention(tp, *map(torch.from_numpy, (q, k, v)), scale=scale,
                              negative_slope=slope, return_stats=True)
    assert since(before) == (1, 0, 0, 0)  # a CPU tensor runs K9's plain version
    assert got.shape == (n, dv) and lse.shape == (tp.padded_nodes,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)


def test_forward_is_the_multi_head_op_at_one_head():
    """K9's plain version is K13's at H = 1, bit for bit. The kernels are no
    longer one: K9 has its own row walk (csrc/attn_fwd.cu), K13 its task
    walk (csrc/attn_mh_fwd.cu), and chip_smoke.py holds each to its plain
    version on the card."""
    a = random_graph(seed=3, n=200)
    _, (tp, _) = plans(a, GEOMETRIES["h128u2"])
    q, k, v = map(torch.from_numpy, qkv(200, 8, 12, seed=4))
    out, lse = spmm_attention(tp, q, k, v, negative_slope=0.2, return_stats=True)
    out_mh, lse_mh = spmm_attention_mh_reference(tp, q[None], k[None], v[None],
                                                 negative_slope=0.2, return_stats=True)
    assert torch.equal(out, out_mh[0]) and torch.equal(lse, lse_mh[0])


@pytest.mark.parametrize("layout", ["padded", "without_blocks"])
def test_empty_windows_match_jax(layout):
    """tests/test_attention.py:94-133: few empty windows are padded with
    zero-bit blocks, many are left without blocks (has_empty_windows).
    Rows without edges: out exactly 0; lse exactly 1e30 in the port, where
    JAX's is > 1e29."""
    n, tail, density, cfg = ((300, 170, 0.02, dict(block_h=64, block_w=128))
                             if layout == "padded" else
                             (2560, 2200, 0.004, dict(block_h=32, block_w=128)))
    a = random_graph(seed=5, n=n, density=density, empty_tail=tail)
    (jp, _), (tp, _) = plans(a, cfg)
    assert tp.has_empty_windows == (layout == "without_blocks")
    q, k, v = qkv(n, 8, 16, seed=6)
    want, want_lse = jax_attention(jp, *map(jnp.asarray, (q, k, v)), scale=1.0,
                                   return_stats=True)
    got, lse = spmm_attention(tp, *map(torch.from_numpy, (q, k, v)), scale=1.0,
                              return_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    deg = np.diff(a.indptr)
    empty = np.r_[deg == 0, np.ones(tp.padded_nodes - n, bool)]
    assert empty[n - tail:].all()
    assert (got.numpy()[deg == 0] == 0.0).all()
    assert (lse.numpy()[empty] == 1e30).all() and (np.asarray(want_lse)[empty] > 1e29).all()
    np.testing.assert_allclose(lse.numpy()[~empty], np.asarray(want_lse)[~empty], **FWD_TOL)


def test_lse_matches_jax_and_dense():
    """tests/test_attention.py:136-150: the lse of return_stats=True."""
    a = random_graph(seed=7, n=150)
    n = a.shape[0]
    (jp, _), (tp, _) = plans(a, GEOMETRIES["h32"])
    q, k, v = qkv(n, 12, 12, seed=8)
    _, want = jax_attention(jp, *map(jnp.asarray, (q, k, v)), scale=0.5, return_stats=True)
    _, lse = spmm_attention(tp, *map(torch.from_numpy, (q, k, v)), scale=0.5,
                            return_stats=True)
    mask = a.toarray() != 0
    has = mask.any(axis=1)
    e = np.where(mask, (q.astype(np.float64) @ k.T.astype(np.float64)) * 0.5, -np.inf)[has]
    m = e.max(axis=1)
    dense = m + np.log(np.exp(e - m[:, None]).sum(axis=1))
    np.testing.assert_allclose(lse.numpy()[:n][has], dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), **FWD_TOL)


def _jax_grads(jp, jpt, q, k, v, w, **kw):
    def loss(q_, k_, v_):
        return jnp.sum(jax_attention_ad(jp, q_, k_, v_, plan_t=jpt, **kw) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                                           (q, k, v)))]


def _port_grads(tp, tpt, q, k, v, w, **kw):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (spmm_attention_ad(tp, *leaves, plan_t=tpt, **kw) * torch.from_numpy(w)).sum().backward()
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("geometry", ["h32", "h128u2"])
def test_gradients_without_plan_t_match_jax(geometry):
    """tests/test_attention.py:153-181: the self-contained backward (K10's
    plain version once, then scatter_lanes) against jax.grad."""
    a = random_graph(seed=9, n=140, density=0.04)
    n, dk, dv = a.shape[0], 12, 20
    (jp, _), (tp, _) = plans(a, GEOMETRIES[geometry])
    q, k, v = qkv(n, dk, dv, seed=10)
    w = np.random.default_rng(11).standard_normal((n, dv)).astype(np.float32)
    kw = dict(scale=1.0 / dk ** 0.5, negative_slope=0.2)
    want = _jax_grads(jp, None, q, k, v, w, **kw)
    before = calls()
    got = _port_grads(tp, None, q, k, v, w, **kw)
    assert since(before) == (1, 1, 0, 0)
    for g, ref, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, ref, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("directed", [False, True], ids=["sym", "directed"])
@pytest.mark.parametrize("pair", [
    ("h32", "h32"), ("h128u2", dict(block_h=64, block_w=128)), ("h256cluster", "h128seg2"),
], ids=["h32", "mixed-unroll", "cluster-vs-seg2"])
def test_gradients_with_plan_t_match_jax(pair, directed):
    """tests/test_attention.py:240-284: the split backward (K11's and K12's
    plain versions once each) against jax.grad, on plan pairs of different
    geometries and on a directed graph."""
    cfg, cfg_t = (GEOMETRIES[p] if isinstance(p, str) else p for p in pair)
    a = random_graph(seed=12, n=140, density=0.05, symmetric=not directed)
    n, dk, dv = a.shape[0], 12, 20
    (jp, jpt), (tp, tpt) = plans(a, cfg, cfg_t)
    q, k, v = qkv(n, dk, dv, seed=13)
    w = np.random.default_rng(14).standard_normal((n, dv)).astype(np.float32)
    kw = dict(scale=1.0 / dk ** 0.5, negative_slope=0.2)
    want = _jax_grads(jp, jpt, q, k, v, w, **kw)
    before = calls()
    got = _port_grads(tp, tpt, q, k, v, w, **kw)
    assert since(before) == (1, 0, 1, 1)
    for g, ref, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, ref, **GRAD_TOL, err_msg=f"d{name}")


def test_the_two_backwards_agree_with_empty_tails():
    """tests/test_attention.py:287-316: split and per-lane backwards agree
    on a graph with isolated tail rows and columns, whose gradients are
    exactly 0 in every plane; both match JAX's."""
    n = 160
    a = random_graph(seed=15, n=n, density=0.03, empty_tail=40)
    (jp, jpt), (tp, tpt) = plans(a, GEOMETRIES["h32"])
    q, k, v = qkv(n, 8, 8, seed=16)
    w = np.random.default_rng(17).standard_normal((n, 8)).astype(np.float32)
    split = _port_grads(tp, tpt, q, k, v, w, negative_slope=0.2)
    lanes = _port_grads(tp, None, q, k, v, w, negative_slope=0.2)
    for s, l, name in zip(split, lanes, "qkv"):
        np.testing.assert_allclose(s, l, **PAIR_TOL, err_msg=f"d{name}")
        assert (s[n - 40:] == 0.0).all() and (l[n - 40:] == 0.0).all()
    for got, ref in zip(split, _jax_grads(jp, jpt, q, k, v, w, negative_slope=0.2)):
        np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("geometry", ["h32", "h128u2", "h256cluster"])
def test_lane_planes_match_jax_kernel(geometry):
    """K10's lane planes against the JAX package's _attn_bwd kernel
    outputs. JAX sums its lane planes with segment_sum over hind inside
    _attn_bwd; given a plan whose hind is the lane index and k, v gathered
    per lane (the same rows its kernel gathers), that sum is the identity,
    so its dk and dv are the planes themselves. Lanes without bits are
    exactly 0 in both."""
    a = random_graph(seed=18, n=300, density=0.03)
    n, dk, dv = a.shape[0], 12, 20
    (jp, _), (tp, _) = plans(a, GEOMETRIES[geometry])
    q, k, v = qkv(n, dk, dv, seed=19)
    g = np.random.default_rng(20).standard_normal((n, dv)).astype(np.float32)
    scale = 1.0 / dk ** 0.5
    out, lse = jax_attention(jp, *map(jnp.asarray, (q, k, v)), scale=scale,
                             negative_slope=0.2, return_stats=True)
    lanes = tp.total_blocks * tp.config.block_w
    hind = np.clip(np.asarray(jp.hind).reshape(-1), 0, n - 1)
    per_lane = dataclasses.replace(jp, hind=jnp.arange(lanes, dtype=jnp.int32).reshape(
        jp.hind.shape), num_cols=lanes)
    want_dq, want_dk, want_dv = jax_attn_bwd(per_lane, jnp.asarray(q), jnp.asarray(k[hind]),
                                             jnp.asarray(v[hind]), out, lse, jnp.asarray(g),
                                             scale=scale, negative_slope=0.2)
    before = calls()
    dq, dk_lane, dv_lane = attention_bwd(tp, *map(torch.from_numpy, (q, k, v)),
                                         torch.from_numpy(np.array(out)),
                                         torch.from_numpy(np.array(lse)), torch.from_numpy(g),
                                         scale=scale, negative_slope=0.2)
    assert since(before) == (0, 1, 0, 0)  # a CPU tensor runs K10's plain version
    assert dk_lane.shape == (lanes, dk) and dv_lane.shape == (lanes, dv)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), **PAIR_TOL)
    np.testing.assert_allclose(dk_lane.numpy(), np.asarray(want_dk), **PAIR_TOL)
    np.testing.assert_allclose(dv_lane.numpy(), np.asarray(want_dv), **PAIR_TOL)
    unset = (tp.bitmask == 0).all(1).reshape(-1).numpy()
    assert unset.any() and not unset.all()
    for plane, ref in ((dk_lane, want_dk), (dv_lane, want_dv)):
        assert (plane.numpy()[unset] == 0.0).all() and (np.asarray(ref)[unset] == 0.0).all()


def test_scatter_lanes_sums_by_hind():
    """Duplicated hind entries (one per window that gathers a row) add;
    lanes past the source rows (a gather_segment plan's tail) are dropped,
    as segment_sum drops them."""
    a = random_graph(seed=21, n=1001, density=0.01)
    n = a.shape[0]
    _, (tp, _) = plans(a, dict(block_h=128, block_w=128, gather_segment=4))
    hind = tp.hind.reshape(-1).numpy()
    assert hind.max() >= n and np.bincount(hind[hind < n]).max() > 1
    plane = np.random.default_rng(22).standard_normal((hind.size, 3)).astype(np.float32)
    got = scatter_lanes(tp, torch.from_numpy(plane), n)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(plane), jnp.asarray(hind),
                                          num_segments=n))
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="plane"):
        scatter_lanes(tp, torch.zeros(hind.size - 1, 3), n)
    # K10's fixed-order sum of the lanes that hold bits (the others are 0)
    sources = plan_lane_sources(tp)
    plane[~(tp.bitmask != 0).any(1).reshape(-1).numpy()] = 0.0
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(plane), jnp.asarray(hind),
                                          num_segments=n))
    fixed = sum_slots_reference(sources, torch.from_numpy(plane)[sources.slot_lane.long()], n)
    np.testing.assert_allclose(fixed.numpy(), want, rtol=1e-5, atol=1e-5)


def test_backward_wrappers_match_the_reference_path():
    """attention_dq, attention_dkv and attention_bwd (the K11, K12 and K10
    wrappers) on CPU tensors run their plain versions; they give what
    impl="reference" gives, bit for bit."""
    n = 120
    a = random_graph(seed=23, n=n, density=0.05, symmetric=False)
    _, (tp, tpt) = plans(a, GEOMETRIES["h32"], dict(block_h=32, block_w=128, block_unroll=2))
    q, k, v = map(torch.from_numpy, qkv(n, 8, 8, seed=24))
    g = torch.from_numpy(np.random.default_rng(25).standard_normal((n, 8)).astype(np.float32))
    out, lse = spmm_attention(tp, q, k, v, scale=0.3, return_stats=True)
    d_row = (g * out).sum(-1)
    before = calls()
    dq = attention_dq(tp, q, k, v, g, lse, d_row, scale=0.3)
    dk, dv = attention_dkv(tpt, q, k, v, g, lse, d_row, scale=0.3)
    dq_l, dk_lane, dv_lane = attention_bwd(tp, q, k, v, out, lse, g, scale=0.3)
    assert since(before) == (0, 1, 1, 1)
    for impl_t, want in ((tpt, (dq, dk, dv)),
                         (None, (dq_l, scatter_lanes(tp, dk_lane, n),
                                 scatter_lanes(tp, dv_lane, n)))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out_ref = spmm_attention_ad(tp, *leaves, plan_t=impl_t, scale=0.3, impl="reference")
        (out_ref * g).sum().backward()
        for got, leaf in zip(want, leaves):
            assert torch.equal(got, leaf.grad)


def test_defaults_scale_and_out_dtype():
    a = random_graph(seed=26, n=100, density=0.05)
    _, (tp, _) = plans(a, GEOMETRIES["h32"])
    q, k, v = map(torch.from_numpy, qkv(100, 16, 8, seed=27))
    default = spmm_attention(tp, q, k, v)
    assert torch.equal(default, spmm_attention(tp, q, k, v, scale=0.25))  # 1 / sqrt(16)
    half = spmm_attention(tp, q, k, v, out_dtype=torch.float16)
    assert half.dtype == torch.float16 and torch.equal(half, default.to(torch.float16))
    assert spmm_attention(tp, q, k, v.double()).dtype == torch.float64
    assert torch.equal(spmm_attention(tp, q, k, v, compute_dtype=torch.float32), default)


def test_no_edges_gives_zeros_and_empty_lse():
    """total_blocks == 0: zeros and lse 1e30, as JAX; zero gradients along
    both backwards."""
    n = 300
    a = sp.csr_matrix((n, n), dtype=np.float32)
    (jp, _), (tp, tpt) = plans(a, dict(block_h=128, block_w=128))
    assert tp.total_blocks == 0
    q, k, v = qkv(n, 8, 4, seed=28)
    want, want_lse = jax_attention(jp, *map(jnp.asarray, (q, k, v)), return_stats=True)
    got, lse = spmm_attention(tp, *map(torch.from_numpy, (q, k, v)), return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (n, 4) and lse.shape == tuple(want_lse.shape) and (lse == 1e30).all()
    for plan_t in (tpt, None):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        spmm_attention_ad(tp, *leaves, plan_t=plan_t).sum().backward()
        assert all(leaf.grad is not None and not leaf.grad.any() for leaf in leaves)


def _weighted(a):
    return vt.csr_preprocess(a.indptr, a.indices, a.shape[0], vt.PlanConfig(32, 128),
                             values=np.ones(a.nnz, np.float32))


REFUSALS = {
    "value plane": (ValueError, "value plane",
                    lambda tp, a, x: spmm_attention(_weighted(a), *x)),
    "value plane (ad)": (ValueError, "value plane",
                         lambda tp, a, x: spmm_attention_ad(_weighted(a), *x)),
    "block_d": (NotImplementedError, "block_d",
                lambda tp, a, x: spmm_attention(tp, *x, block_d=128)),
    "precision": (NotImplementedError, "item 9",
                  lambda tp, a, x: spmm_attention(tp, *x, precision="highest")),
    "precision (ad)": (NotImplementedError, "item 9",
                       lambda tp, a, x: spmm_attention_ad(tp, *x, precision="highest")),
    "interpret": (NotImplementedError, "interpret",
                  lambda tp, a, x: spmm_attention(tp, *x, interpret=True)),
    "not the transpose": (ValueError, "transpose",
                          lambda tp, a, x: spmm_attention_ad(
                              tp, *x, plan_t=dataclasses.replace(tp, num_cols=101))),
    "impl": (ValueError, "impl", lambda tp, a, x: spmm_attention_ad(tp, *x, impl="pallas")),
    "stacks": (ValueError, "one head",
               lambda tp, a, x: spmm_attention(tp, *(t[None] for t in x))),
    "rows": (ValueError, "rows", lambda tp, a, x: spmm_attention(tp, x[0][:50], x[1], x[2])),
    "meta device": (ValueError, "cuda or cpu",
                    lambda tp, a, x: spmm_attention(tp, *(t.to("meta") for t in x))),
    "out and g (bwd)": (ValueError, "out",
                        lambda tp, a, x: attention_bwd(tp, *x, x[2][:, :4], None, x[2],
                                                       scale=1.0)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    exc, match, call = REFUSALS[case]
    a = random_graph(seed=29, n=100, density=0.05)
    _, (tp, _) = plans(a, GEOMETRIES["h32"])
    x = tuple(map(torch.from_numpy, qkv(100, 8, 8, seed=30)))
    with pytest.raises(exc, match=match):
        call(tp, a, x)


def test_lane_kernel_source_builds_for_sm90a(tmp_path, monkeypatch):
    """K10 builds as K13-K15 do: one nvcc for csrc/attn_bwd.cu, for sm_90a,
    with csrc/ on the include path for the shared edge walk."""
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
    assert os.path.basename(compiler.build("attn_bwd", ["attn_bwd.cu"]).path) == "libattn_bwd.so"
    with open(os.path.join(compiler.CSRC_DIR, "attn_bwd.cu")) as f:
        assert '#include "attn_mh_common.cuh"' in f.read()
    (cmd,) = [line.split() for line in log.read_text().splitlines()]
    assert cmd[-1] == os.path.join(compiler.CSRC_DIR, "attn_bwd.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd and f"-I{compiler.CSRC_DIR}" in cmd


def test_attn_fwd_source_builds_for_sm90a(tmp_path, monkeypatch):
    """K9 builds from its own source: one nvcc for csrc/attn_fwd.cu, for
    sm_90a, with csrc/ on the include path for the row walk it shares with
    K10 (csrc/attn_walk.cuh)."""
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
    assert os.path.basename(compiler.build("attn_fwd", ["attn_fwd.cu"]).path) == "libattn_fwd.so"
    for source in ("attn_fwd.cu", "attn_bwd.cu"):
        with open(os.path.join(compiler.CSRC_DIR, source)) as f:
            text = f.read()
        assert '#include "attn_walk.cuh"' in text
        assert "atomicAdd" not in text  # sums in a fixed order
    (cmd,) = [line.split() for line in log.read_text().splitlines()]
    assert cmd[-1] == os.path.join(compiler.CSRC_DIR, "attn_fwd.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd and f"-I{compiler.CSRC_DIR}" in cmd


# --- K9's pieces and K10's source order --------------------------------------

def power_law(n=1500, edges=15000, seed=3):
    """A symmetrised Chung-Lu graph: its first window holds the hubs."""
    return symmetrize(chung_lu_csr(n, edges, seed=seed))


def k9_walk(plan, piece_blocks, piece_work):
    """attention_walk(plan, "spmm_attention") at the given limits."""
    saved = PIECE_BLOCKS["spmm_attention"], PIECE_WORK["spmm_attention"]
    try:
        PIECE_BLOCKS["spmm_attention"], PIECE_WORK["spmm_attention"] = piece_blocks, piece_work
        return attention_walk(plan, "spmm_attention")
    finally:
        PIECE_BLOCKS["spmm_attention"], PIECE_WORK["spmm_attention"] = saved


def emulate_k9(plan, q, k, v, scale, slope, piece_blocks, piece_work):
    """K9's split in plain torch: each piece of a 128-row group runs the
    online softmax over its own edges alone, leaving its share (m, l,
    acc); a group's shares merge in piece order, each rescaled by exp(m -
    M) with M the row's largest share maximum. Returns out and lse."""
    cfg = plan.config
    n, dv = q.shape[0], v.shape[1]
    out = torch.zeros(n, dv)
    lse = torch.full((plan.padded_nodes,), 1e30)
    groups = {}
    for row in k9_walk(plan, piece_blocks, piece_work).tasks.tolist():
        groups.setdefault((row[0], row[1]), []).append(row)
    for (w, g), rows in groups.items():
        r0 = w * cfg.block_h + 128 * g
        r1 = min(r0 + 128, (w + 1) * cfg.block_h)
        shares = []
        for _, _, b0, b1, _, _ in sorted(rows, key=lambda r: r[4]):
            sub = dataclasses.replace(plan, bitmask=plan.bitmask[b0:b1], hind=plan.hind[b0:b1],
                                      window_of_block=plan.window_of_block[b0:b1],
                                      total_blocks=b1 - b0)
            er, ec, _ = _edges(sub)
            keep = (er >= r0) & (er < min(r1, n))
            er, ec = er[keep] - r0, ec[keep]
            s = _act((q[er + r0] * k[ec]).sum(-1), scale, slope)
            m = torch.full((r1 - r0,), -1e30).scatter_reduce(0, er, s, "amax")
            p = torch.exp(s - m[er])
            shares.append((m, torch.zeros(r1 - r0).index_add_(0, er, p),
                           torch.zeros(r1 - r0, dv).index_add_(0, er, p[:, None] * v[ec])))
        big = torch.stack([m for m, _, _ in shares]).amax(0)
        den, acc = torch.zeros(r1 - r0), torch.zeros(r1 - r0, dv)
        for m, l, a in shares:  # in piece order
            f = torch.exp(m - big)
            den, acc = den + l * f, acc + a * f[:, None]
        live = slice(r0, min(r1, n))
        out[live] = (acc / den.clamp_min(1e-30)[:, None])[:live.stop - r0]
        lse[r0:r1] = torch.where(den > 0, big + torch.log(den.clamp_min(1e-30)), 1e30)
    return out, lse


K9_CASES = {
    # a hub window cut into many pieces, by the block limit and by the work limit
    "hub-blocks": (power_law, dict(block_h=128, block_w=128), (1, None)),
    "hub-work": (power_law, dict(block_h=128, block_w=128, block_unroll=2), (16, 40)),
    "tall-windows": (power_law, dict(block_h=256, block_w=128), (1, None)),
    # windows left without blocks, and windows of zero-bit blocks
    "empty-without-blocks": (lambda: random_graph(seed=5, n=2560, density=0.004, empty_tail=2200),
                             dict(block_h=32, block_w=128), (1, None)),
    "empty-padded": (lambda: random_graph(seed=5, n=300, density=0.02, empty_tail=170),
                     dict(block_h=64, block_w=128), (1, None)),
}


@pytest.mark.parametrize("case", list(K9_CASES))
def test_piece_emulation_of_k9_matches_jax(case):
    """K9's pieces, each an online softmax over its own edges, merged in
    piece order, against JAX's spmm_attention (its Pallas kernel, as the
    file runs it) at FWD_TOL; rows without edges 0 with lse 1e30."""
    graph, cfg, limits = K9_CASES[case]
    a = graph()
    n = a.shape[0]
    (jp, _), (tp, _) = plans(a, cfg)
    tasks = k9_walk(tp, *limits).tasks.numpy()
    if case.startswith("hub") or case == "tall-windows":
        assert np.bincount(tasks[:, 0])[0] >= 8  # the hub window, cut into many pieces
    else:
        assert (tp.has_empty_windows if case == "empty-without-blocks"
                else not tp.has_empty_windows and (tp.bitmask == 0).all(2).all(1).any())
    q, k, v = qkv(n, 12, 20, seed=31)
    scale = 1.0 / 12 ** 0.5
    want, want_lse = jax_attention(jp, *map(jnp.asarray, (q, k, v)), scale=scale,
                                   negative_slope=0.2, return_stats=True)
    got, lse = emulate_k9(tp, *map(torch.from_numpy, (q, k, v)), scale, 0.2, *limits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    empty = np.r_[np.diff(a.indptr) == 0, np.ones(tp.padded_nodes - n, bool)]
    assert (got.numpy()[empty[:n]] == 0.0).all() and (lse.numpy()[empty] == 1e30).all()
    np.testing.assert_allclose(lse.numpy()[~empty], np.asarray(want_lse)[~empty], **FWD_TOL)


@pytest.mark.parametrize("cfg", [dict(block_h=128, block_w=128, gather_segment=4),
                                 dict(block_h=64, block_w=128, block_unroll=2),
                                 dict(block_h=256, block_w=128, cluster_cols=True)])
def test_k10_source_order(cfg):
    """Each lane that holds a bit once; the lanes whose hind lies in [0, n)
    grouped by hind (source s's slots offsets[s] .. offsets[s + 1]), in
    lane order within a source; the lanes whose hind lies outside after
    them, dropped from the sums; the order the same as the kept one."""
    a = random_graph(seed=32, n=1001, density=0.01)
    n = a.shape[0]
    _, (tp, _) = plans(a, cfg)
    held = (tp.bitmask != 0).any(1).reshape(-1).numpy()
    if cfg.get("gather_segment"):  # lanes with bits whose hind lies outside [0, n)
        hind = tp.hind.reshape(-1).clone()
        out = np.flatnonzero(held)[::7]
        hind[out[::2]], hind[out[1::2]] = n + 3, -2
        tp = dataclasses.replace(tp, hind=hind.view(tp.hind.shape))
    src = lane_source_order(tp)
    lane, lane_slot, slot_lane = (t.numpy() for t in (src.lane, src.lane_slot, src.slot_lane))
    offsets = src.offsets.numpy()
    assert np.array_equal(lane, np.flatnonzero(held))  # each once, in lane order
    assert np.array_equal(np.flatnonzero(lane_slot >= 0), lane)
    assert np.array_equal(np.sort(lane_slot[lane]), np.arange(len(lane)))
    assert np.array_equal(slot_lane[lane_slot[lane]], lane)
    hind = tp.hind.reshape(-1).numpy()[slot_lane]
    inside = (hind >= 0) & (hind < n)
    assert offsets.shape == (n + 1,) and offsets[0] == 0 and offsets[-1] == inside.sum()
    assert inside[:offsets[-1]].all() and not inside[offsets[-1]:].any()
    for s in range(n):
        mine = slot_lane[offsets[s]:offsets[s + 1]]
        assert (hind[offsets[s]:offsets[s + 1]] == s).all() and np.all(np.diff(mine) > 0)
    if cfg.get("gather_segment"):
        assert (~inside).sum() == len(out)
        plane = torch.from_numpy(np.random.default_rng(35).standard_normal(
            (held.size, 3)).astype(np.float32)) * torch.from_numpy(held)[:, None]
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(plane.numpy()),
                                              jnp.asarray(tp.hind.reshape(-1).numpy()),
                                              num_segments=n))
        got = sum_slots_reference(src, plane[src.slot_lane.long()], n)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert plan_lane_sources(tp) is plan_lane_sources(dataclasses.replace(tp, num_cols=n))


@pytest.mark.parametrize("cfg", [dict(block_h=128, block_w=128, block_unroll=2),
                                 dict(block_h=128, block_w=128, gather_segment=4)])
def test_gradients_without_plan_t_take_the_card_path(cfg):
    """spmm_attention_ad without plan_t on CPU tensors runs the card path's
    Python code with the plain kernels: K10's plain version once, its lane
    planes in the source order, summed in that order; against jax.grad on
    a hub graph and on lanes past the source rows, and close to the plain
    path's scatter_lanes sums."""
    a = power_law(n=1001, edges=12000)
    n, dk, dv = a.shape[0], 12, 20
    (jp, _), (tp, _) = plans(a, cfg)
    q, k, v = qkv(n, dk, dv, seed=33)
    w = np.random.default_rng(34).standard_normal((n, dv)).astype(np.float32)
    kw = dict(scale=1.0 / dk ** 0.5, negative_slope=0.2)
    want = _jax_grads(jp, None, q, k, v, w, **kw)
    before = calls()
    got = _port_grads(tp, None, q, k, v, w, **kw)
    assert since(before) == (1, 1, 0, 0)
    for g, ref, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, ref, **GRAD_TOL, err_msg=f"d{name}")
    out, lse = spmm_attention(tp, *map(torch.from_numpy, (q, k, v)), return_stats=True,
                              negative_slope=0.2)
    args = (tp, *map(torch.from_numpy, (q, k, v)), out, lse, torch.from_numpy(w))
    dq, dk_sum, dv_sum = attention_bwd_summed(*args, **kw)
    dq_l, dk_lane, dv_lane = attention_bwd_reference(*args, **kw)
    assert torch.equal(dq, dq_l)
    for fixed, plane in ((dk_sum, dk_lane), (dv_sum, dv_lane)):
        np.testing.assert_allclose(fixed.numpy(), scatter_lanes(tp, plane, n).numpy(), **PAIR_TOL)

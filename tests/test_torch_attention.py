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
from voltrix_spmm_tpu_torch.ops import (
    attention_bwd,
    attention_bwd_reference,
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
    """K9 is K13 at H = 1: the plain versions agree bit for bit."""
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
    "compute_dtype": (NotImplementedError, "item 9",
                      lambda tp, a, x: spmm_attention(tp, *x, compute_dtype=torch.bfloat16)),
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

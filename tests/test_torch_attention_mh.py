"""Parity of the PyTorch port's multi-head fused attention
(voltrix_spmm_tpu_torch/ops/attention_mh.py) with the JAX package on the
CPU.

The same numpy graph and q, k, v go through both packages. The port runs
the plain versions of kernels K13, K14 and K15 on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_attention.py
does. Tolerances: the forward and lse at rtol 1e-5 / atol 1e-6 with
float32 planes (tests/test_attention.py:347) and rtol 1e-4 / atol 1e-5
with bf16 planes; gradients at rtol 1e-4 / atol 1e-5 with float32 planes
and max error over max magnitude < 1e-3 with bf16 planes
(tests/test_attention.py:456-459), since JAX carries lse and D through its
bf16 plane as hi/lo pairs and the port reads them in float32.

K13's split (its work list, `attention_walk(plan, "spmm_attention_mh")`:
each piece an online softmax per head over its own edges, a cut group's
shares merged per head in piece order) is emulated in plain torch and held
to JAX's `spmm_attention_mh` at the same tolerances. So are K14's and
K15's (`attention_walk(plan, "attention_mh_dq")`, and over the transpose
plan "attention_mh_dkv": each piece's partial dq, or dk and dv, over its
own blocks, the partials added in piece order), held to `jax.grad` of
`spmm_attention_mh_ad` at the gradients' tolerances.
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

import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.jit.compiler as compiler
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.format import csr_preprocess as jax_csr_preprocess
from voltrix_spmm_tpu.ops import spmm_attention_mh as jax_mh
from voltrix_spmm_tpu.ops import spmm_attention_mh_ad as jax_mh_ad
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.format.stream import slice_plan_windows
from voltrix_spmm_tpu_torch.ops import (
    attention_mh_dkv,
    attention_mh_dkv_reference,
    attention_mh_dq,
    attention_mh_dq_reference,
    spmm_attention_mh,
    spmm_attention_mh_ad,
    spmm_attention_mh_reference,
)
from voltrix_spmm_tpu_torch.ops._attn_core import (
    BWD_ACC_WIDTHS,
    _act,
    _ds,
    _edges,
    _rounded,
    bwd_geometry,
)
import voltrix_spmm_tpu_torch.ops._attn_core as attn_core_module
from voltrix_spmm_tpu_torch.ops.attention import attention_walk
import voltrix_spmm_tpu_torch.ops.attention_mh as attention_mh_module
from voltrix_spmm_tpu_torch.ops.attention_mh import MH_ACC_WIDTHS, mh_geometry
from voltrix_spmm_tpu_torch.ops.block_spmm import PIECE_BLOCKS, PIECE_WORK

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PLANES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def graph(n, density, seed, symmetric=True, empty_tail=0, isolated_every=0):
    """A random binary graph; with empty_tail, its last rows and columns
    are emptied (whole empty windows); with isolated_every, so is every
    such row and column inside (rows without edges in non-empty windows)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    a.data[:] = 1.0
    if symmetric:
        a = ((a + a.T) != 0).astype(np.float32).tocsr()
    keep = np.ones(n)
    if empty_tail:
        keep[n - empty_tail:] = 0
    if isolated_every:
        keep[::isolated_every] = 0
    a = (sp.diags(keep) @ a @ sp.diags(keep)).tocsr()
    a.eliminate_zeros()
    a.sort_indices()
    return a


def plans(a, cfg, cfg_t=None):
    """((JAX plan, JAX plan_t), (port plan, port plan_t)) for A and A^T."""
    n = a.shape[0]
    at = a.T.tocsr()
    cfg_t = cfg_t or cfg
    jp = (jax_csr_preprocess(a.indptr, a.indices, n, JaxPlanConfig(*cfg)),
          jax_csr_preprocess(at.indptr, at.indices, n, JaxPlanConfig(*cfg_t)))
    tp = (vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(*cfg)),
          vt.csr_preprocess(at.indptr, at.indices, n, vt.PlanConfig(*cfg_t)))
    return jp, tp


def qkv(heads, n, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((heads, n, dk), (heads, n, dk), (heads, n, dv)))


def calls():
    return (spmm_attention_mh_reference.calls, attention_mh_dq_reference.calls,
            attention_mh_dkv_reference.calls)


def since(before):
    return tuple(a - b for a, b in zip(calls(), before))


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("heads,dk,dv", [(1, 8, 8), (3, 12, 20)], ids=["h1d8", "h3d12x20"])
@pytest.mark.parametrize("slope", [1.0, 0.2], ids=["ident", "leaky"])
@pytest.mark.parametrize("cfg", [(32, 128), (128, 128, 1, 2)], ids=["h32", "h128u2"])
def test_forward_and_lse_match_jax(cfg, slope, heads, dk, dv, plane):
    a = graph(200, 0.04, seed=1)
    (jp, _), (tp, _) = plans(a, cfg)
    q, k, v = qkv(heads, 200, dk, dv, seed=2)
    jdt, tdt = PLANES[plane]
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), negative_slope=slope,
                            plane_dtype=jdt, return_stats=True)
    before = calls()
    got, lse = spmm_attention_mh(tp, *map(torch.from_numpy, (q, k, v)), negative_slope=slope,
                                 plane_dtype=tdt, return_stats=True)
    assert since(before) == (1, 0, 0)  # a CPU tensor runs K13's plain version
    tol = F32_TOL if plane == "f32" else BF16_TOL
    assert got.shape == (heads, 200, dv) and lse.shape == (heads, tp.padded_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["padded", "without_blocks"])
def test_empty_windows_and_isolated_rows_match_jax(layout, plane):
    """Empty tail windows (padded with zero-bit blocks when they are few,
    left without blocks when they dominate: format/preprocess.py
    pad_empty_windows) and rows without edges inside non-empty windows:
    out exactly 0 and lse exactly 1e30 there."""
    n, tail = (180, 50) if layout == "padded" else (2400, 2304)
    a = graph(n, 0.04, seed=3, empty_tail=tail, isolated_every=9)
    (jp, _), (tp, _) = plans(a, (32, 128))
    assert tp.has_empty_windows == (layout == "without_blocks")
    q, k, v = qkv(2, n, 8, 8, seed=4)
    jdt, tdt = PLANES[plane]
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), scale=0.5, plane_dtype=jdt,
                            return_stats=True)
    got, lse = spmm_attention_mh(tp, *map(torch.from_numpy, (q, k, v)), scale=0.5,
                                 plane_dtype=tdt, return_stats=True)
    tol = F32_TOL if plane == "f32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)
    empty = np.r_[np.diff(a.indptr) == 0, np.ones(tp.padded_nodes - n, bool)]
    assert empty[n - tail:].all() and empty[:n - tail:9].all()
    assert (lse.numpy()[:, empty] == 1e30).all() and (lse.numpy()[:, ~empty] < 1e29).all()
    assert (got.numpy()[:, empty[:n]] == 0.0).all()


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("directed", [False, True], ids=["sym", "directed"])
def test_gradients_match_jax_grad(directed, plane):
    """jax.grad of spmm_attention_mh_ad against the port's backward, which
    runs K14's and K15's plain versions once each and does not
    differentiate through the plain forward. The directed graph's plan_t
    has its own PlanConfig (tests/test_attention.py:373-384)."""
    n, heads, dk, dv = 150, 3, 12, 20
    a = graph(n, 0.05, seed=5, symmetric=not directed)
    (jp, jpt), (tp, tpt) = plans(a, (32, 128), (64, 128, 1, 2))
    q, k, v = qkv(heads, n, dk, dv, seed=6)
    w = np.random.default_rng(7).standard_normal((heads, n, dv)).astype(np.float32)
    jdt, tdt = PLANES[plane]

    def jloss(q_, k_, v_):
        out = jax_mh_ad(jp, q_, k_, v_, plan_t=jpt, negative_slope=0.2, plane_dtype=jdt)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = calls()
    out = spmm_attention_mh_ad(tp, *leaves, plan_t=tpt, negative_slope=0.2, plane_dtype=tdt)
    (out * torch.from_numpy(w)).sum().backward()
    assert since(before) == (1, 1, 1)
    for got, ref, name in zip(leaves, want, "qkv"):
        ref = np.asarray(ref)
        if plane == "f32":
            np.testing.assert_allclose(got.grad.numpy(), ref, **GRAD_TOL, err_msg=f"d{name}")
        else:
            err = np.abs(got.grad.numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-3, f"d{name}: {err:.3e}"


def test_backward_wrappers_match_jax_kernels():
    """attention_mh_dq and attention_mh_dkv (the K14 and K15 wrappers) on CPU
    tensors run their plain versions, with the JAX gradient as the oracle;
    the same answer as impl="reference"."""
    n, heads = 120, 2
    a = graph(n, 0.05, seed=8, symmetric=False)
    (jp, jpt), (tp, tpt) = plans(a, (32, 128), (32, 128, 1, 2))
    q, k, v = qkv(heads, n, 8, 8, seed=9)
    g = np.random.default_rng(10).standard_normal((heads, n, 8)).astype(np.float32)
    want = jax.grad(lambda *t: jnp.sum(jax_mh_ad(jp, *t, plan_t=jpt, scale=0.3) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt_, gt = map(torch.from_numpy, (q, k, v, g))
    out, lse = spmm_attention_mh(tp, qt, kt, vt_, scale=0.3, return_stats=True)
    d_row = (gt * out).sum(-1)
    before = calls()
    dq = attention_mh_dq(tp, qt, kt, vt_, gt, lse, d_row, scale=0.3)
    dk, dv = attention_mh_dkv(tpt, qt, kt, vt_, gt, lse, d_row, scale=0.3)
    assert since(before) == (0, 1, 1)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt_)]
    out_ref = spmm_attention_mh_ad(tp, *leaves, plan_t=tpt, scale=0.3, impl="reference")
    (out_ref * gt).sum().backward()
    for got, leaf in zip((dq, dk, dv), leaves):
        assert torch.equal(got, leaf.grad)


def test_defaults_scale_and_out_dtype():
    a = graph(100, 0.05, seed=11)
    (_, _), (tp, _) = plans(a, (32, 128))
    q, k, v = map(torch.from_numpy, qkv(2, 100, 16, 8, seed=12))
    default = spmm_attention_mh(tp, q, k, v)
    assert torch.equal(default, spmm_attention_mh(tp, q, k, v, scale=0.25))  # 1 / sqrt(16)
    half = spmm_attention_mh(tp, q, k, v, out_dtype=torch.float16)
    assert half.dtype == torch.float16 and torch.equal(half, default.to(torch.float16))
    assert spmm_attention_mh(tp, q, k, v.double()).dtype == torch.float64


def _weighted(tp, a):
    return vt.csr_preprocess(a.indptr, a.indices, a.shape[0], vt.PlanConfig(32, 128),
                             values=np.ones(a.nnz, np.float32))


REFUSALS = {
    "value plane": (ValueError, "value plane",
                    lambda tp, a, x: spmm_attention_mh(_weighted(tp, a), *x)),
    "value plane (ad)": (ValueError, "value plane",
                         lambda tp, a, x: spmm_attention_mh_ad(_weighted(tp, a), *x, plan_t=tp)),
    "plan_t None": (ValueError, "plan_t",
                    lambda tp, a, x: spmm_attention_mh_ad(tp, *x, plan_t=None)),
    # subtile=True is taken (test_subtile_matches_jax) where block_h % 128 == 0,
    # which JAX asserts (attention_mh.py:307-308); these plans have block_h 32
    "subtile": (ValueError, "block_h % 128",
                lambda tp, a, x: spmm_attention_mh(tp, *x, subtile=True)),
    "subtile (ad)": (ValueError, "block_h % 128",
                     lambda tp, a, x: spmm_attention_mh_ad(tp, *x, plan_t=tp, subtile=True)),
    "precision": (NotImplementedError, "item 9",
                  lambda tp, a, x: spmm_attention_mh(tp, *x, precision="highest")),
    "plane dtype": (ValueError, "plane_dtype",
                    lambda tp, a, x: spmm_attention_mh(tp, *x, plane_dtype=torch.float16)),
    "impl": (ValueError, "impl",
             lambda tp, a, x: spmm_attention_mh_ad(tp, *x, plan_t=tp, impl="pallas")),
    "not the transpose": (ValueError, "transpose",
                          lambda tp, a, x: spmm_attention_mh_ad(
                              tp, *x, plan_t=dataclasses.replace(tp, num_cols=101))),
    "shapes": (ValueError, "rows",
               lambda tp, a, x: spmm_attention_mh(tp, x[0][:, :50], x[1], x[2])),
    "meta device": (ValueError, "cuda or cpu",
                    lambda tp, a, x: spmm_attention_mh(tp, *(t.to("meta") for t in x))),
    "meta device (dq)": (ValueError, "cuda or cpu",
                         lambda tp, a, x: attention_mh_dq(tp, *(t.to("meta") for t in x),
                                                          x[2].to("meta"), None, None, scale=1.0)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    exc, match, call = REFUSALS[case]
    a = graph(100, 0.05, seed=13)
    (_, _), (tp, _) = plans(a, (32, 128))
    x = tuple(map(torch.from_numpy, qkv(2, 100, 8, 8, seed=14)))
    with pytest.raises(exc, match=match):
        call(tp, a, x)


@pytest.mark.parametrize("directed", [False, True], ids=["sym", "directed"])
def test_subtile_matches_jax(directed):
    """subtile=True on clustered plans (PlanConfig(256, 128,
    cluster_cols=True)): JAX's kernels skip empty 128-row sub-windows, the
    port's visit only set bits; forward, lse and gradients with plan_t
    against JAX's subtile=True at the float32 tolerances."""
    n, heads, dk, dv = 300, 2, 12, 20
    a = graph(n, 0.03, seed=19, symmetric=not directed)
    (jp, jpt), (tp, tpt) = plans(a, (256, 128, 1, 1, True))
    q, k, v = qkv(heads, n, dk, dv, seed=20)
    w = np.random.default_rng(21).standard_normal((heads, n, dv)).astype(np.float32)
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), negative_slope=0.2,
                            return_stats=True, subtile=True)
    got, lse = spmm_attention_mh(tp, *map(torch.from_numpy, (q, k, v)), negative_slope=0.2,
                                 return_stats=True, subtile=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32_TOL)

    def jloss(q_, k_, v_):
        out = jax_mh_ad(jp, q_, k_, v_, plan_t=jpt, negative_slope=0.2, subtile=True)
        return jnp.sum(out * w)

    grads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = spmm_attention_mh_ad(tp, *leaves, plan_t=tpt, negative_slope=0.2, subtile=True)
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, ref, name in zip(leaves, grads, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_no_edges_gives_zeros_and_empty_lse():
    """total_blocks == 0: zeros, lse 1e30 (as JAX), and zero gradients."""
    n = 300
    a = sp.csr_matrix((n, n), dtype=np.float32)
    (jp, _), (tp, tpt) = plans(a, (128, 128))
    assert tp.total_blocks == 0
    q, k, v = qkv(2, n, 8, 4, seed=15)
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), return_stats=True)
    got, lse = spmm_attention_mh(tp, *map(torch.from_numpy, (q, k, v)), return_stats=True)
    assert got.shape == (2, n, 4) and not got.any()
    assert lse.shape == tuple(want_lse.shape) and (lse == 1e30).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    spmm_attention_mh_ad(tp, *leaves, plan_t=tpt).sum().backward()
    assert all(leaf.grad is not None and not leaf.grad.any() for leaf in leaves)


def _fake_nvcc(tmp_path):
    """An executable standing in for nvcc: answers --version, logs each
    compile and writes the -o file."""
    log = tmp_path / "nvcc.log"
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "if '--version' in sys.argv:\n"
        "    print('fake nvcc 0.0'); sys.exit(0)\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n"
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path), log


def test_attention_kernel_sources_build_for_sm90a(tmp_path, monkeypatch):
    """K13, K14 and K15 build as K1-K7 do: one nvcc per source, for sm_90a,
    with csrc/ on the include path for their shared headers. K13 lives in
    K9's source, csrc/attn_fwd.cu; all three walk rows with
    csrc/attn_walk.cuh, with no atomics. The old source of K13 is gone."""
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setenv(vt.project.NVCC_FLAG, nvcc)
    monkeypatch.setenv(vt.project.BUILD_DIR_FLAG, str(tmp_path / "kernels"))
    monkeypatch.setattr(compiler, "runtime_cache", {})
    names = ("attn_fwd", "attn_mh_dq", "attn_mh_dkv")
    for name in names:
        assert os.path.basename(compiler.build(name, [f"{name}.cu"]).path) == f"lib{name}.so"
        with open(os.path.join(compiler.CSRC_DIR, f"{name}.cu")) as f:
            text = f.read()
        assert '#include "attn_walk.cuh"' in text
        assert not re.search(r"\batomic\w*\s*\(", text)  # sums in a fixed order
        if name == "attn_fwd":
            assert "voltrix_attn_mh_fwd" in text
    assert not os.path.exists(os.path.join(compiler.CSRC_DIR, "attn_mh_fwd.cu"))
    cmds = [line.split() for line in log.read_text().splitlines()]
    assert [c[-1] for c in cmds] == [os.path.join(compiler.CSRC_DIR, f"{s}.cu") for s in names]
    assert all("arch=compute_90a,code=sm_90a" in c and f"-I{compiler.CSRC_DIR}" in c
               for c in cmds)


def test_attention_slice_matches_jax():
    """The op as path G of chip_smoke.py uses it, at a small size: a
    symmetric power-law graph with self-loops, PlanConfig(128, 128,
    block_unroll=4), 8 heads of width 8 and bf16 planes: forward and
    gradients against JAX."""
    from voltrix_spmm_tpu.data import chung_lu_csr, symmetrize

    a = symmetrize(chung_lu_csr(300, 1200, seed=16))
    a = ((a + sp.eye(a.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    n = a.shape[0]
    (jp, _), (tp, _) = plans(a, (128, 128, 1, 4))
    q, k, v = qkv(8, n, 8, 8, seed=17)
    w = np.random.default_rng(18).standard_normal((8, n, 8)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jax_mh_ad(jp, q_, k_, v_, plan_t=jp, negative_slope=0.2, plane_dtype=jnp.bfloat16)
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = spmm_attention_mh_ad(tp, *leaves, plan_t=tp, negative_slope=0.2,
                               plane_dtype=torch.bfloat16)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **BF16_TOL)
    for got, ref in zip(leaves, grads):
        ref = np.asarray(ref)
        assert np.abs(got.grad.numpy() - ref).max() / np.abs(ref).max() < 1e-3


# --- K13's pieces -----------------------------------------------------------

def k13_walk(plan, piece_blocks, piece_work):
    """attention_walk(plan, "spmm_attention_mh") at the given limits."""
    name = "spmm_attention_mh"
    saved = PIECE_BLOCKS[name], PIECE_WORK[name]
    try:
        PIECE_BLOCKS[name], PIECE_WORK[name] = piece_blocks, piece_work
        return attention_walk(plan, name)
    finally:
        PIECE_BLOCKS[name], PIECE_WORK[name] = saved


def emulate_k13(plan, q, k, v, scale, slope, plane, limits):
    """K13's split in plain torch, for H heads: k and v rounded through the
    plane's dtype; each piece of a 128-row group runs, for every head, the
    online softmax over its own edges alone, leaving its share (m, l,
    acc); a group's shares merge per head in piece order, each rescaled by
    exp(m - M) with M the row's largest share maximum. Returns out (H, n,
    dv) and lse (H, padded_nodes)."""
    cfg = plan.config
    heads, n, dv = q.shape[0], q.shape[1], v.shape[2]
    kf, vf = _rounded(k, plane), _rounded(v, plane)
    out = torch.zeros(heads, n, dv)
    lse = torch.full((heads, plan.padded_nodes), 1e30)
    groups = {}
    for row in k13_walk(plan, *limits).tasks.tolist():
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
            s = _act((q[:, er + r0] * kf[:, ec]).sum(-1), scale, slope)  # (H, E)
            idx = er.expand(heads, -1)
            m = torch.full((heads, r1 - r0), -1e30).scatter_reduce(1, idx, s, "amax")
            p = torch.exp(s - m.gather(1, idx))
            shares.append((m, torch.zeros(heads, r1 - r0).index_add_(1, er, p),
                           torch.zeros(heads, r1 - r0, dv).index_add_(1, er,
                                                                      p[..., None] * vf[:, ec])))
        big = torch.stack([m for m, _, _ in shares]).amax(0)
        den, acc = torch.zeros(heads, r1 - r0), torch.zeros(heads, r1 - r0, dv)
        for m, l, a in shares:  # in piece order, per head
            f = torch.exp(m - big)
            den, acc = den + l * f, acc + a * f[..., None]
        live = min(r1, n) - r0
        out[:, r0:r0 + live] = (acc / den.clamp_min(1e-30)[..., None])[:, :live]
        lse[:, r0:r1] = torch.where(den > 0, big + torch.log(den.clamp_min(1e-30)), 1e30)
    return out, lse


def power_law(n=1500, edges=15000, seed=3):
    """A symmetrised Chung-Lu graph: its first window holds the hubs."""
    return symmetrize(chung_lu_csr(n, edges, seed=seed))


K13_CASES = {  # graph, plan config, (heads, dk, dv), plane, piece limits
    # a hub window cut into many pieces, by the block limit and by the work limit
    "hub-blocks-h8-bf16": (power_law, (128, 128), (8, 8, 8), "bf16", (1, None)),
    "hub-work-h1-f32": (power_law, (128, 128, 1, 2), (1, 12, 20), "f32", (16, 40)),
    "hub-work-h8-f32": (power_law, (128, 128, 1, 4), (8, 8, 8), "f32", (4, 60)),
    "tall-windows-h1-bf16": (power_law, (256, 128), (1, 40, 40), "bf16", (1, None)),
    # windows left without blocks, and windows of zero-bit blocks
    "empty-without-blocks-h8": (lambda: graph(2560, 0.004, seed=5, empty_tail=2200),
                                (32, 128), (8, 8, 8), "bf16", (1, None)),
    "empty-padded-h1": (lambda: graph(300, 0.02, seed=5, empty_tail=170), (64, 128),
                        (1, 12, 20), "f32", (1, None)),
}


@pytest.mark.parametrize("case", list(K13_CASES))
def test_piece_emulation_of_k13_matches_jax(case):
    """K13's pieces, each a per-head online softmax over its own edges,
    merged per head in piece order, against JAX's spmm_attention_mh (its
    Pallas kernel in interpret mode) with float32 or bf16 planes; rows
    without edges 0 with lse 1e30."""
    make, cfg, (heads, dk, dv), plane, limits = K13_CASES[case]
    a = make()
    n = a.shape[0]
    (jp, _), (tp, _) = plans(a, cfg)
    tasks = k13_walk(tp, *limits).tasks.numpy()
    if case.startswith(("hub", "tall")):
        assert np.bincount(tasks[:, 0])[0] >= 8  # the hub window, cut into many pieces
    else:
        assert (tp.has_empty_windows if "without" in case
                else not tp.has_empty_windows and (tp.bitmask == 0).all(2).all(1).any())
    q, k, v = qkv(heads, n, dk, dv, seed=31)
    scale = 1.0 / dk ** 0.5
    jdt, tdt = PLANES[plane]
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), scale=scale, negative_slope=0.2,
                            plane_dtype=jdt, return_stats=True)
    got, lse = emulate_k13(tp, *map(torch.from_numpy, (q, k, v)), scale, 0.2, tdt, limits)
    tol = F32_TOL if plane == "f32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    empty = np.r_[np.diff(a.indptr) == 0, np.ones(tp.padded_nodes - n, bool)]
    assert (got.numpy()[:, empty[:n]] == 0.0).all() and (lse.numpy()[:, empty] == 1e30).all()
    np.testing.assert_allclose(lse.numpy()[:, ~empty], np.asarray(want_lse)[:, ~empty], **tol)


@pytest.mark.parametrize("num_chunks", [2, 3])
def test_piece_emulation_of_k13_on_window_chunks_matches_jax(num_chunks):
    """K13 on the window chunks of a plan (format/stream.py:
    slice_plan_windows; the hub window is cut the same way in its chunk),
    each chunk's rows from its own split, against JAX on the whole plan:
    8 heads on bf16 planes."""
    a = power_law()
    n = a.shape[0]
    (jp, _), (tp, _) = plans(a, (128, 128, 1, 4))
    q, k, v = qkv(8, n, 8, 8, seed=32)
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), negative_slope=0.2,
                            plane_dtype=jnp.bfloat16, return_stats=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    outs, lses, r0 = [], [], 0
    for sub in slice_plan_windows(tp, num_chunks):
        out, lse = emulate_k13(sub, tq[:, r0:r0 + sub.num_nodes], tk, tv, 1.0 / 8 ** 0.5, 0.2,
                               torch.bfloat16, (2, 100))
        outs.append(out)
        lses.append(lse)
        r0 += sub.num_nodes
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(want), **BF16_TOL)
    np.testing.assert_allclose(torch.cat(lses, 1).numpy(), np.asarray(want_lse), **BF16_TOL)


@pytest.mark.parametrize("heads,dv,want", [
    (8, 8, (8, 8)), (1, 40, (1, 40)), (3, 20, (2, 40)), (2, 16, (2, 16)), (1, 300, (1, 64)),
    (8, 200, (1, 64)), (5, 8, (8, 8)), (4, 12, (4, 16)),
])
def test_k13_head_group_and_column_chunk(heads, dv, want, monkeypatch):
    """K13's head group is the smallest power of two holding min(H,
    HEAD_GROUP) heads, halved until a chunk of its registers holds dv (or
    one head is left); its chunk is the narrowest that holds dv, else the
    widest. Every pair it picks is one that csrc/attn_fwd.cu instantiates."""
    monkeypatch.setattr(attention_mh_module, "HEAD_GROUP", 8)
    got = mh_geometry(heads, dv)
    assert got == want
    assert got[1] in MH_ACC_WIDTHS[got[0]]


# --- K14's and K15's pieces --------------------------------------------------

def bwd_walk(plan, name, piece_blocks, piece_work):
    """attention_walk(plan, name) of K14 or K15 at the given limits."""
    saved = PIECE_BLOCKS[name], PIECE_WORK[name]
    try:
        PIECE_BLOCKS[name], PIECE_WORK[name] = piece_blocks, piece_work
        return attention_walk(plan, name)
    finally:
        PIECE_BLOCKS[name], PIECE_WORK[name] = saved


def emulate_pieces(plan, name, limits, heads, widths, part):
    """The split of K14 (name "attention_mh_dq") or K15 ("attention_mh_dkv",
    `plan` the transpose plan) in plain torch: each piece of a 128-row
    group takes the edges of its own blocks whose row lies in the group and
    gives its partial rows (`part(rows, cols)`: each edge's terms, one
    tensor (H, edges, d) per output of width d in `widths`); a group's
    partials are added in piece order. Rows without edges come out 0."""
    cfg = plan.config
    n = plan.num_nodes
    outs = [torch.zeros(heads, n, d) for d in widths]
    groups = {}
    for row in bwd_walk(plan, name, *limits).tasks.tolist():
        groups.setdefault((row[0], row[1]), []).append(row)
    for (w, g), rows in groups.items():
        r0 = w * cfg.block_h + 128 * g
        r1 = min(r0 + 128, (w + 1) * cfg.block_h, n)
        if r1 <= r0:
            continue
        total = None
        for _, _, b0, b1, _, _ in sorted(rows, key=lambda r: r[4]):
            sub = dataclasses.replace(plan, bitmask=plan.bitmask[b0:b1], hind=plan.hind[b0:b1],
                                      window_of_block=plan.window_of_block[b0:b1],
                                      total_blocks=b1 - b0)
            er, ec, _ = _edges(sub)
            keep = (er >= r0) & (er < r1)
            er, ec = er[keep], ec[keep]
            parts = [torch.zeros(heads, r1 - r0, d).index_add_(1, er - r0, x)
                     for d, x in zip(widths, part(er, ec))]
            total = parts if total is None else [a + b for a, b in zip(total, parts)]
        for out, t in zip(outs, total):
            out[:, r0:r1] = t
    return outs


def emulate_k14(plan, q, k, v, g, lse, d_row, scale, slope, plane, limits):
    """K14's pieces: dq (H, n, dk), each piece's ds k[src] over its edges;
    k and v rounded through the plane's dtype, q and dO float32."""
    kf, vf = _rounded(k, plane), _rounded(v, plane)

    def part(r, c):
        raw = (q[:, r] * kf[:, c]).sum(-1)
        p = torch.exp(_act(raw, scale, slope) - lse[:, r])
        ds = _ds(p, (g[:, r] * vf[:, c]).sum(-1), d_row[:, r], raw, scale, slope)
        return [ds[..., None] * kf[:, c]]

    return emulate_pieces(plan, "attention_mh_dq", limits, q.shape[0], [q.shape[2]], part)[0]


def emulate_k15(plan_t, q, k, v, g, lse, d_row, scale, slope, plane, limits):
    """K15's pieces over the transpose plan: (dk, dv), each piece's ds q[dst]
    and p dO[dst] over its edges; q, k, v and dO rounded through the plane's
    dtype."""
    qf, kf, vf, gf = (_rounded(t, plane) for t in (q, k, v, g))

    def part(r, c):  # r: rows of k and v, c: rows of q and dO
        raw = (kf[:, r] * qf[:, c]).sum(-1)
        p = torch.exp(_act(raw, scale, slope) - lse[:, c])
        ds = _ds(p, (vf[:, r] * gf[:, c]).sum(-1), d_row[:, c], raw, scale, slope)
        return [ds[..., None] * qf[:, c], p[..., None] * gf[:, c]]

    return emulate_pieces(plan_t, "attention_mh_dkv", limits, q.shape[0],
                          [k.shape[2], v.shape[2]], part)


def jax_grads(jp, jpt, q, k, v, w, plane):
    """dq, dk and dv of sum(spmm_attention_mh_ad(...) * w) by jax.grad."""
    def jloss(q_, k_, v_):
        out = jax_mh_ad(jp, q_, k_, v_, plan_t=jpt, negative_slope=0.2,
                        plane_dtype=PLANES[plane][0])
        return jnp.sum(out * w)

    return [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


def bwd_inputs(tp, q, k, v, w, plane):
    """The backward's inputs on the port's side: q, k, v and dO as tensors,
    the plain forward's lse and D = rowsum(dO o out)."""
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, w))
    out, lse = spmm_attention_mh_reference(tp, tq, tk, tv, return_stats=True,
                                           negative_slope=0.2, plane_dtype=PLANES[plane][1])
    return tq, tk, tv, tg, lse, (tg * out).sum(-1)


def assert_grads(got, want, plane, what):
    """GRAD_TOL with float32 planes; max error over max magnitude < 1e-3
    with bf16 planes (test_gradients_match_jax_grad's rules)."""
    for x, ref, name in zip(got, want, what):
        if plane == "f32":
            np.testing.assert_allclose(x.numpy(), ref, **GRAD_TOL, err_msg=name)
        else:
            err = np.abs(x.numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-3, f"{name}: {err:.3e}"


BWD_CASES = {  # graph, plan config, transpose plan config, (heads, dk, dv), plane, piece limits
    # a hub window cut into many pieces, by the block limit and by the work limit
    "hub-blocks-h8-bf16": (power_law, (128, 128), None, (8, 8, 8), "bf16", (1, None)),
    "hub-work-h1-f32": (power_law, (128, 128, 1, 2), None, (1, 12, 20), "f32", (16, 40)),
    "hub-work-h3-f32": (power_law, (128, 128, 1, 4), None, (3, 8, 8), "f32", (4, 60)),
    # windows left without blocks and isolated rows: dq, dk and dv exactly 0 there
    "empty-isolated-h8-bf16": (lambda: graph(2560, 0.004, seed=5, empty_tail=2200,
                                             isolated_every=7),
                               (32, 128), None, (8, 8, 8), "bf16", (1, None)),
    "empty-isolated-h1-f32": (lambda: graph(300, 0.02, seed=5, empty_tail=170, isolated_every=5),
                              (64, 128), None, (1, 12, 20), "f32", (1, None)),
    # a directed graph: plan_t is not plan, with a geometry of its own
    "directed-h3-f32": (lambda: graph(300, 0.03, seed=9, symmetric=False), (32, 128),
                        (64, 128, 1, 2), (3, 12, 20), "f32", (2, 100)),
    "directed-h3-bf16": (lambda: graph(300, 0.03, seed=9, symmetric=False), (32, 128),
                         (64, 128, 1, 2), (3, 12, 20), "bf16", (2, 100)),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_piece_emulation_of_k14_and_k15_matches_jax_grad(case):
    """K14's pieces (dq over the plan) and K15's (dk, dv over the transpose
    plan), each piece's partial rows over its own blocks added in piece
    order, against jax.grad of JAX's spmm_attention_mh_ad (its Pallas
    kernels in interpret mode) with float32 or bf16 planes; rows without
    edges exactly 0."""
    make, cfg, cfg_t, (heads, dk, dv), plane, limits = BWD_CASES[case]
    a = make()
    n = a.shape[0]
    (jp, jpt), (tp, tpt) = plans(a, cfg, cfg_t)
    if case.startswith("hub"):
        for p, name in ((tp, "attention_mh_dq"), (tpt, "attention_mh_dkv")):
            assert np.bincount(bwd_walk(p, name, *limits).tasks[:, 0].numpy())[0] >= 8
    elif case.startswith("empty"):
        assert tp.has_empty_windows or (tp.bitmask == 0).all(2).all(1).any()
    else:
        assert tpt is not tp and (tpt.config.block_h, tpt.config.block_unroll) == (64, 2)
    q, k, v = qkv(heads, n, dk, dv, seed=33)
    w = np.random.default_rng(34).standard_normal((heads, n, dv)).astype(np.float32)
    want = jax_grads(jp, jpt, q, k, v, w, plane)
    bwd = bwd_inputs(tp, q, k, v, w, plane)
    args = (1.0 / dk ** 0.5, 0.2, PLANES[plane][1], limits)
    got = [emulate_k14(tp, *bwd, *args), *emulate_k15(tpt, *bwd, *args)]
    assert_grads(got, want, plane, ("dq", "dk", "dv"))
    no_in = np.diff(a.indptr) == 0  # rows of dq without edges
    no_out = np.diff(a.tocsc().indptr) == 0  # rows of dk and dv without edges
    assert (got[0].numpy()[:, no_in] == 0.0).all()
    assert all((x.numpy()[:, no_out] == 0.0).all() for x in got[1:])
    if case.startswith("empty"):
        assert no_in.any() and no_out.any()


@pytest.mark.parametrize("num_chunks", [2, 3])
def test_piece_emulation_of_k14_and_k15_on_window_chunks_matches_jax_grad(num_chunks):
    """K14 and K15 on the window chunks of their plans (format/stream.py:
    slice_plan_windows; the hub window is cut the same way in its chunk),
    each chunk's rows from its own split, against jax.grad on the whole
    plans: 8 heads on bf16 planes."""
    a = power_law()
    n = a.shape[0]
    (jp, jpt), (tp, tpt) = plans(a, (128, 128, 1, 4))
    q, k, v = qkv(8, n, 8, 8, seed=35)
    w = np.random.default_rng(36).standard_normal((8, n, 8)).astype(np.float32)
    want = jax_grads(jp, jpt, q, k, v, w, "bf16")
    tq, tk, tv, tg, lse, d_row = bwd_inputs(tp, q, k, v, w, "bf16")
    args = (1.0 / 8 ** 0.5, 0.2, torch.bfloat16, (2, 100))
    dq, r0 = [], 0
    for sub in slice_plan_windows(tp, num_chunks):  # rows of q, dO, lse and D
        rows = slice(r0, r0 + sub.num_nodes)
        dq.append(emulate_k14(sub, tq[:, rows], tk, tv, tg[:, rows], lse[:, rows],
                              d_row[:, rows], *args))
        r0 += sub.num_nodes
    dk, dv, r0 = [], [], 0
    for sub in slice_plan_windows(tpt, num_chunks):  # rows of k and v
        rows = slice(r0, r0 + sub.num_nodes)
        part = emulate_k15(sub, tq, tk[:, rows], tv[:, rows], tg, lse, d_row, *args)
        dk.append(part[0])
        dv.append(part[1])
        r0 += sub.num_nodes
    got = [torch.cat(x, 1) for x in (dq, dk, dv)]
    assert_grads(got, want, "bf16", ("dq", "dk", "dv"))


def _instantiated(source, macro):
    """The (head group, column chunk) pairs that `source` dispatches to."""
    with open(os.path.join(compiler.CSRC_DIR, source)) as f:
        return {tuple(map(int, m)) for m in re.findall(rf"^  {macro}\((\d+), (\d+)\)$",
                                                        f.read(), re.M)}


@pytest.mark.parametrize("name,heads,d,want", [
    ("attention_mh_dq", 8, 8, (4, 8)), ("attention_mh_dq", 1, 40, (1, 40)),
    ("attention_mh_dkv", 3, 20, (1, 32)), ("attention_mh_dkv", 2, 16, (2, 16)),
    ("attention_mh_dq", 1, 300, (1, 64)), ("attention_mh_dkv", 8, 200, (1, 64)),
    ("attention_mh_dq", 3, 8, (4, 8)), ("attention_mh_dkv", 4, 12, (2, 16)),
    ("attention_dq", 8, 8, (1, 8)), ("attention_dkv", 1, 40, (1, 40)),
])
def test_k14_k15_head_group_and_column_chunk(name, heads, d, want, monkeypatch):
    """K14's and K15's head group is the smallest power of two holding
    min(H, BWD_HEAD_GROUP[name]) heads (one for K11 and K12), halved until a
    chunk of its registers holds d (or one head is left); its chunk is the
    narrowest that holds d, else the widest. Every pair it picks is one
    that csrc/attn_mh_dq.cu and csrc/attn_mh_dkv.cu both instantiate, and
    they instantiate exactly BWD_ACC_WIDTHS."""
    monkeypatch.setattr(attn_core_module, "BWD_HEAD_GROUP",
                        {"attention_mh_dq": 4, "attention_mh_dkv": 4})
    got = bwd_geometry(name, heads, d)
    assert got == want
    pairs = {(hg, w) for hg, widths in BWD_ACC_WIDTHS.items() for w in widths}
    assert _instantiated("attn_mh_dq.cu", "VOLTRIX_DQ") == pairs
    assert _instantiated("attn_mh_dkv.cu", "VOLTRIX_DKV") == pairs
    assert got in pairs

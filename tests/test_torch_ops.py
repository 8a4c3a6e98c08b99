"""Parity of the PyTorch port's SpMM, its gradient and its neighbour
aggregation with the JAX package on the CPU.

On a CPU tensor the port runs kernel K1's plain version; the JAX side runs
`spmm_pallas` in interpret mode, as tests/test_spmm.py does. The kernel
itself runs only on the card and is checked against the same plain version
there by chip_smoke.py. Tolerances are those of tests/test_spmm.py:51-52
(float32 sums taken in another order).
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

import voltrix_spmm_tpu as jvx
import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu.utils as jutils
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.jit.compiler as compiler
from voltrix_spmm_tpu.format.ell import csr_preprocess_ell
from voltrix_spmm_tpu.format.hybrid import csr_preprocess_hybrid
from voltrix_spmm_tpu.format.stream import slice_plan_windows
from voltrix_spmm_tpu_torch.models.graph import aggregate
from voltrix_spmm_tpu_torch.ops import (
    expand_bitmask,
    spmm_block,
    spmm_ell_reference,
    spmm_fused_reference,
    spmm_reference,
    spmm_scipy,
    spmm_weighted_reference,
)
from voltrix_spmm_tpu_torch.ops.block_spmm import _check

TOL = dict(rtol=1e-5, atol=1e-4)


def random_csr(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a


def drop_rows(a, keep):
    mask = np.array([keep(r) for r in range(a.shape[0])], dtype=np.float32)
    return (sp.diags(mask) @ a).tocsr()


def both_plans(a, **cfg):
    n = a.shape[0]
    jplan = jvx.csr_preprocess(a.indptr, a.indices, n, jvx.PlanConfig(**cfg), backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg))
    return jplan, tplan


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def assert_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert vt.calc_diff(out, ref) < 1e-6
    np.testing.assert_allclose(out, ref, **TOL)


# tests/test_spmm.py:36-45 plus the port's own edge geometries; "auto"
# sends the gather_segment >= 8 plan to kernel K3's wrapper, as JAX does
SPMM_CASES = [
    (512, 0.05, 64, dict(block_h=128, block_w=128), "auto"),
    (300, 0.02, 130, dict(block_h=32, block_w=128), "auto"),
    (1000, 0.01, 256, dict(block_h=128, block_w=256), "auto"),
    (512, 0.05, 64, dict(block_h=32, block_w=128, block_unroll=4), "auto"),
    (400, 0.03, 96, dict(block_h=32, block_w=128, gather_segment=8, block_unroll=2), "auto"),
    (1001, 0.01, 40, dict(block_h=128, block_w=128, gather_segment=4), "auto"),
    (1024, 0.02, 72, dict(block_h=128, block_w=128), "auto"),  # words with bit 31 set
]


@pytest.mark.parametrize("n,density,d,cfg,impl", SPMM_CASES)
def test_spmm_matches_jax_pallas(n, density, d, cfg, impl):
    a = random_csr(n, density, seed=n + d)
    jplan, tplan = both_plans(a, **cfg)
    x = features(n, d, seed=1)
    ref = np.asarray(jops.spmm_pallas(jplan, jnp.asarray(x)))
    out = vt.spmm(tplan, torch.from_numpy(x), impl=impl)
    assert out.dtype == torch.float32
    assert_close(out, ref)
    assert_close(out, spmm_scipy(a.indptr, a.indices, n, x))


@pytest.mark.parametrize("case", ["padded", "left_empty", "empty_matrix"])
def test_spmm_empty_windows_match_jax(case):
    n, d = 2048, 48
    a = random_csr(n, 0.01, seed=5)
    if case == "padded":
        a, cfg, has_empty = drop_rows(a, lambda r: not 256 <= r < 512), dict(block_h=128), False
    elif case == "left_empty":
        # 63 of 64 windows empty: padding them would outnumber the real blocks
        a, cfg, has_empty = drop_rows(a, lambda r: r < 32), dict(block_h=32, block_unroll=2), True
    else:
        a, cfg, has_empty = random_csr(n, 0.0, seed=5), dict(block_h=128), True
    jplan, tplan = both_plans(a, **cfg)
    assert tplan.has_empty_windows == has_empty
    x = features(n, d, seed=2)
    out = vt.spmm(tplan, torch.from_numpy(x))
    assert_close(out, np.asarray(jops.spmm_pallas(jplan, jnp.asarray(x))))
    assert_close(out, spmm_scipy(a.indptr, a.indices, n, x))


def test_expand_bitmask_matches_jax():
    a = random_csr(1024, 0.02, seed=3)
    jplan, tplan = both_plans(a, block_h=128, block_w=128)
    assert bool((tplan.bitmask < 0).any())
    words = tplan.bitmask[:5]
    out = expand_bitmask(words, 128)
    ref = np.stack([np.asarray(jops.expand_bitmask(jnp.asarray(w), 128))
                    for w in jplan.bitmask[:5]])
    np.testing.assert_array_equal(out.numpy(), ref)
    assert bool(out[:, 31::32].any())  # bit 31 expands to rows 31, 63, ...
    with pytest.raises(TypeError, match="int32"):
        expand_bitmask(words.to(torch.int64), 128)


def test_spmm_batched_matches_jax():
    n, b, d = 500, 3, 20
    a = random_csr(n, 0.03, seed=7)
    jplan, tplan = both_plans(a, block_h=64, block_w=128)
    x = np.random.default_rng(3).standard_normal((b, n, d)).astype(np.float32)
    out = vt.spmm(tplan, torch.from_numpy(x))
    assert tuple(out.shape) == (b, n, d)
    assert_close(out, np.asarray(jvx.spmm(jplan, jnp.asarray(x), impl="pallas")))


def test_spmm_out_dtype():
    n, d = 300, 16
    _, tplan = both_plans(random_csr(n, 0.05, seed=8))
    x = torch.from_numpy(features(n, d, seed=4))
    out = vt.spmm(tplan, x, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    full = vt.spmm(tplan, x)
    assert torch.equal(out, full.to(torch.bfloat16))


def _plan_kinds():
    a = random_csr(256, 0.05, seed=9)
    n = a.shape[0]
    tplan = vt.csr_preprocess(a.indptr, a.indices, n)
    seg8 = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(32, 128, gather_segment=8))
    return {
        # weighted plans are ported; one in the TPU's incidence order is not
        "values": dataclasses.replace(tplan, values=torch.ones(tplan.total_blocks, 128, 128),
                                      src_perm=torch.arange(n, dtype=torch.int32)),
        "seg_interleaved": dataclasses.replace(
            seg8, config=vt.PlanConfig(32, 128, gather_segment=8, block_unroll=8,
                                       seg_interleaved=True)),
        "src_perm": dataclasses.replace(tplan, src_perm=torch.arange(n, dtype=torch.int32)),
        "ell": csr_preprocess_ell(a.indptr, a.indices, n),
        "hybrid": csr_preprocess_hybrid(a.indptr, a.indices, n, backend="numpy"),
        "plan_list": slice_plan_windows(
            jvx.csr_preprocess(a.indptr, a.indices, n, backend="numpy"), 2),
    }


@pytest.mark.parametrize("kind", ["values", "seg_interleaved",
                                  "src_perm", "ell", "hybrid", "plan_list"])
def test_spmm_refuses_unported_plans(kind):
    plan = _plan_kinds()[kind]
    x = torch.zeros(256, 8)
    if kind == "values":
        # a weighted plan is ported: "auto" sends it to K4 (its plain
        # version on the CPU); in the TPU's incidence order it is refused
        calls = spmm_weighted_reference.calls
        out = vt.spmm(dataclasses.replace(plan, src_perm=None), x)
        assert spmm_weighted_reference.calls == calls + 1 and tuple(out.shape) == (256, 8)
    a = random_csr(256, 0.05, seed=9)
    if kind == "ell":
        # the port's EllPlan is ported: "auto" sends it to K6 (its plain
        # version on the CPU); the JAX package's EllPlan is refused
        calls = spmm_ell_reference.calls
        out = vt.spmm(vt.csr_preprocess_ell(a.indptr, a.indices, 256), x)
        assert spmm_ell_reference.calls == calls + 1 and tuple(out.shape) == (256, 8)
    if kind == "hybrid":
        # the port's HybridPlan runs K3 and K1 (their plain versions on the
        # CPU); the JAX package's HybridPlan is refused
        hplan = vt.csr_preprocess_hybrid(a.indptr, a.indices, 256, threshold=8)
        assert hplan.dense.total_blocks and hplan.sparse.total_blocks
        calls = spmm_fused_reference.calls, spmm_reference.calls
        out = vt.spmm(hplan, x)
        assert (spmm_fused_reference.calls, spmm_reference.calls) == (calls[0] + 1, calls[1] + 1)
        assert tuple(out.shape) == (256, 8)
    if kind == "plan_list":
        # the port's window chunks run K1 chunk by chunk and equal the whole
        # plan's result; a list of the JAX package's chunks is refused
        whole = vt.csr_preprocess(a.indptr, a.indices, 256)
        xr = torch.from_numpy(features(256, 8, seed=9))
        assert torch.equal(vt.spmm(vt.slice_plan_windows(whole, 2), xr), vt.spmm(whole, xr))
    foreign = kind in ("ell", "hybrid", "plan_list")
    match = "not a plan of the port" if foreign else "ROADMAP.md item 18"
    with pytest.raises(NotImplementedError, match=match):
        vt.spmm(plan, x)


def test_spmm_rejects_bad_arguments():
    n = 256
    _, tplan = both_plans(random_csr(n, 0.05, seed=10))
    with pytest.raises(ValueError, match="unknown impl"):
        vt.spmm(tplan, torch.zeros(n, 8), impl="cusparse")
    with pytest.raises(ValueError, match="rows"):
        vt.spmm(tplan, torch.zeros(n + 1, 8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm_block(tplan.to("meta"), torch.zeros(n, 8, device="meta"))


def test_spmm_block_on_cpu_runs_the_plain_version():
    n, d = 300, 24
    a = random_csr(n, 0.05, seed=11)
    _, tplan = both_plans(a)
    x = torch.from_numpy(features(n, d, seed=5))
    launches, calls = spmm_block.launches, spmm_reference.calls
    out = spmm_block(tplan, x)
    assert spmm_block.launches == launches  # no kernel launch on the CPU
    assert spmm_reference.calls == calls + 1
    assert torch.equal(out, spmm_reference(tplan, x))


def test_spmm_block_checks_what_the_kernel_takes():
    n, d = 300, 24
    _, tplan = both_plans(random_csr(n, 0.05, seed=12))
    x = torch.zeros(n, d)
    _check(tplan, x)  # a well-formed call passes
    with pytest.raises(TypeError, match="float32"):
        _check(tplan, x.double())
    with pytest.raises(ValueError, match="source_rows"):
        _check(tplan, torch.zeros(n - 1, d))
    with pytest.raises(ValueError, match="contiguous"):
        _check(tplan, torch.zeros(d, n).t())
    with pytest.raises(ValueError, match="SpmmPlan.to"):
        _check(tplan.to("meta"), x)
    with pytest.raises(ValueError, match="int32"):
        _check(dataclasses.replace(tplan, hind=tplan.hind.long()), x)
    with pytest.raises(ValueError, match="natural lane order"):
        _check(dataclasses.replace(tplan, src_perm=torch.arange(n, dtype=torch.int32)), x)


def _fake_nvcc(tmp_path, fail=False):
    """An executable standing in for nvcc: answers --version, logs each
    compile, and writes the -o file (or fails)."""
    log = tmp_path / "nvcc.log"
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "if '--version' in sys.argv:\n"
        "    print('fake nvcc 0.0'); sys.exit(0)\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        + ("print('error: refused'); sys.exit(2)\n" if fail else
           "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path), log


def test_build_is_content_addressed_and_cached(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setenv(vt.project.NVCC_FLAG, nvcc)
    monkeypatch.setenv(vt.project.BUILD_DIR_FLAG, str(tmp_path / "kernels"))
    monkeypatch.setattr(compiler, "runtime_cache", {})
    rt = compiler.build("spmm_block", ["spmm_block.cu"])
    assert os.path.dirname(os.path.dirname(rt.path)) == str(tmp_path / "kernels")
    assert os.path.basename(rt.path) == "libspmm_block.so"
    cmd = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == os.path.join(compiler.CSRC_DIR, "spmm_block.cu")
    # the same sources build once, even with the in-process cache cleared
    monkeypatch.setattr(compiler, "runtime_cache", {})
    assert compiler.build("spmm_block", ["spmm_block.cu"]).path == rt.path
    assert len(log.read_text().splitlines()) == 1
    assert not [f for f in os.listdir(os.path.dirname(rt.path)) if f.endswith(".tmp")]


def test_weighted_kernel_sources_build_for_sm90a(tmp_path, monkeypatch):
    """K4 and K5 build as K1 does: one nvcc per source, for sm_90a."""
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setenv(vt.project.NVCC_FLAG, nvcc)
    monkeypatch.setenv(vt.project.BUILD_DIR_FLAG, str(tmp_path / "kernels"))
    monkeypatch.setattr(compiler, "runtime_cache", {})
    for name in ("spmm_weighted", "spmm_dvalues"):
        assert os.path.basename(compiler.build(name, [f"{name}.cu"]).path) == f"lib{name}.so"
    cmds = [line.split() for line in log.read_text().splitlines()]
    assert [c[-1] for c in cmds] == [os.path.join(compiler.CSRC_DIR, f"{s}.cu")
                                     for s in ("spmm_weighted", "spmm_dvalues")]
    assert all("arch=compute_90a,code=sm_90a" in c for c in cmds)


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, fail=True)
    monkeypatch.setenv(vt.project.NVCC_FLAG, nvcc)
    monkeypatch.setenv(vt.project.BUILD_DIR_FLAG, str(tmp_path / "kernels"))
    monkeypatch.setattr(compiler, "runtime_cache", {})
    with pytest.raises(RuntimeError, match="error: refused"):
        compiler.build("spmm_block", ["spmm_block.cu"])
    for _, _, files in os.walk(tmp_path / "kernels"):
        assert not files  # no partial library is left behind


def test_no_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.delenv(vt.project.NVCC_FLAG, raising=False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(compiler.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        compiler.get_nvcc()


def test_spmm_ad_gradient_matches_jax():
    n, d = 600, 48
    a = random_csr(n, 0.02, seed=13)
    assert (a != a.T).nnz  # asymmetric: the backward needs the transpose plan
    at = a.T.tocsr()
    jplan, tplan = both_plans(a, block_h=64, block_w=128)
    jplan_t, tplan_t = both_plans(at, block_h=64, block_w=128)
    x = features(n, d, seed=6)
    w = features(n, d, seed=7)

    def jloss(xj):
        return jnp.sum(jops.spmm_ad(jplan, jplan_t, xj) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vt.spmm_ad(tplan, tplan_t, xt)
    (out * torch.from_numpy(w)).sum().backward()
    assert_close(out.detach(), spmm_scipy(a.indptr, a.indices, n, x))
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), at @ w, **TOL)


@pytest.mark.parametrize("mode", ["mean", "sum", "sym"])
def test_aggregate_matches_jax(mode):
    n, d = 700, 40
    a = random_csr(n, 0.02, seed=14)
    gj = jmodels.build_graph(a.indptr, a.indices, n, jvx.PlanConfig(64, 128), backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(64, 128), device="cpu")
    x = features(n, d, seed=8)
    out = aggregate(gt, torch.from_numpy(x), mode)
    assert_close(out, np.asarray(jmodels.aggregate(gj, jnp.asarray(x), mode)))
    xb = np.random.default_rng(9).standard_normal((2, n, d)).astype(np.float32)
    outb = aggregate(gt, torch.from_numpy(xb), mode)
    assert tuple(outb.shape) == (2, n, d)
    assert_close(outb, np.asarray(jmodels.aggregate(gj, jnp.asarray(xb), mode)))


def test_accuracy_helpers_match_jax():
    rng = np.random.default_rng(16)
    x = rng.standard_normal((50, 7)).astype(np.float32)
    y = x + 1e-3 * rng.standard_normal((50, 7)).astype(np.float32)
    for a, b in ((x, y), (x, x), (np.zeros(3), np.zeros(3))):
        assert vt.calc_diff(torch.from_numpy(a), b) == jutils.calc_diff(a, b)
        assert vt.relative_error(a, torch.from_numpy(b)) == jutils.relative_error(a, b)
    assert vt.calc_diff(x, x) == 0.0 and vt.calc_diff(x, y) > 0.0


def test_aggregate_rejects_unknown_mode():
    n = 200
    a = random_csr(n, 0.05, seed=15)
    gt = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(64, 128), device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation mode"):
        aggregate(gt, torch.zeros(n, 4), "max")

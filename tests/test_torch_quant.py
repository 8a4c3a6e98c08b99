"""Parity of the port's int8 SpMM (kernel K8's plain version), its per-row
quantization and the fp8 helpers with the JAX package on the CPU.

The JAX side runs `spmm_pallas_int8` in interpret mode, as
tests/test_quant.py does. Both compute each gathered value as
bf16(bf16(q) * bf16(scale)) and sum in float32, so the two agree to rtol
1e-5, atol 1e-5 (float32 sums in another order); a float32
dequantization without the bfloat16 rounding misses that limit by orders
of magnitude. The scipy oracle limits are test_quant.py's (2e-2, 3e-2
with outliers). Quantized rows, scales and fp8 values are compared bit
for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu as jvx
import voltrix_spmm_tpu.utils as jutils
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.jit.compiler as compiler
import voltrix_spmm_tpu_torch.utils as tutils
from voltrix_spmm_tpu.ops import dequantize_rows as jdequantize_rows
from voltrix_spmm_tpu.ops import quantize_rows as jquantize_rows
from voltrix_spmm_tpu.ops import spmm_pallas_int8
from voltrix_spmm_tpu_torch.ops import spmm_int8, spmm_int8_reference, spmm_scipy
from voltrix_spmm_tpu_torch.ops.reference import block_sum, clipped_gather

TOL = dict(rtol=1e-5, atol=1e-5)


def random_csr(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", random_state=np.random.default_rng(seed))
    a.data[:] = 1.0
    return a


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def with_duplicates(a, seed):
    """(indptr, indices) of `a` with a fifth of its edges repeated."""
    coo = a.tocoo()
    pick = np.random.default_rng(seed).random(coo.nnz) < 0.2
    rows = np.concatenate([coo.row, coo.row[pick]])
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(a.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=a.shape[0]), out=indptr[1:])
    return indptr, np.concatenate([coo.col, coo.col[pick]])[order]


def community_csr(n=1024, seed=3):
    """Edges mostly inside 128-node communities: clustered windows whose
    sub-window occupancy has clear bits."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 6 * n)
    local = rng.random(rows.shape[0]) < 0.8
    cols = np.where(local, rows // 128 * 128 + rng.integers(0, 128, rows.shape[0]),
                    rng.integers(0, n, rows.shape[0]))
    a = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(n, n))
    a.data[:] = 1.0
    return a


# chip_smoke.py's K8 geometries, at the CPU's size: (label, csr, n, d,
# config, feature maker)
def k8_cases():
    er = random_csr(512, 0.05, seed=1)
    empty_windows = sp.diags((np.arange(4096) < 64).astype(np.float32)) @ random_csr(4096, 0.004, 2)
    zero_rows = features(300, 48, seed=3)
    zero_rows[::3] = 0.0
    return {
        "n512 d64 PlanConfig(32,128)": (er, 64, dict(block_h=32), None),
        "n300 d130 (d not a multiple of 4)": (random_csr(300, 0.02, 4), 130, dict(block_h=32), None),
        "n300 d1": (random_csr(300, 0.02, 5), 1, dict(block_h=32), None),
        "clustered PlanConfig(256,128,cluster_cols)": (
            community_csr(), 40, dict(block_h=256, cluster_cols=True), None),
        "coverage seg 8": (random_csr(500, 0.02, 6), 24, dict(block_h=64, gather_segment=8), None),
        "coverage seg 128, tail lanes past n": (
            random_csr(700, 0.01, 7), 24,
            dict(block_h=256, gather_segment=128, block_unroll=4), None),
        "empty windows": (sp.csr_matrix(empty_windows), 16, dict(block_h=32), None),
        "all-zero feature rows": (random_csr(300, 0.03, 8), 48, dict(block_h=32), zero_rows),
        "gen_outlier_normal rows": (
            random_csr(400, 0.04, 9), 64, dict(block_h=32),
            tutils.gen_outlier_normal((400, 64), outlier_frac=0.02, seed=1)),
        "duplicate edges": (random_csr(400, 0.03, 10), 40, dict(block_h=32), "dup"),
    }


def both_plans(indptr, indices, n, **cfg):
    jplan = jvx.csr_preprocess(indptr, indices, n, jvx.PlanConfig(**cfg), backend="numpy")
    tplan = vt.csr_preprocess(indptr, indices, n, vt.PlanConfig(**cfg))
    return jplan, tplan


def case_inputs(label):
    a, d, cfg, feat = k8_cases()[label]
    a = sp.csr_matrix(a)
    n = a.shape[0]
    dup = isinstance(feat, str)
    indptr, indices = with_duplicates(a, 11) if dup else (a.indptr, a.indices)
    if feat is None or dup:
        feat = features(n, d, seed=len(label))
    jplan, tplan = both_plans(indptr, indices, n, block_w=128, **cfg)
    return indptr, indices, n, feat, jplan, tplan


@pytest.mark.parametrize("label", list(k8_cases()))
def test_int8_reference_matches_jax(label):
    indptr, indices, n, x, jplan, tplan = case_inputs(label)
    if "empty windows" in label:
        assert tplan.has_empty_windows
    if "tail lanes" in label:
        assert int(tplan.hind.max()) >= n
    ref = np.asarray(spmm_pallas_int8(jplan, jnp.asarray(x)))
    out = spmm_int8_reference(tplan, torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.equal(vt.spmm(tplan, torch.from_numpy(x), impl="int8"), out)


def test_int8_batched_matches_jax():
    """A (B, N, D) batch folds into the feature axis, so the rows are
    quantized across the whole batch in both packages."""
    n, b, d = 400, 3, 20
    a = random_csr(n, 0.03, seed=12)
    jplan, tplan = both_plans(a.indptr, a.indices, n, block_h=32, block_w=128)
    x = np.random.default_rng(13).standard_normal((b, n, d)).astype(np.float32)
    x[1] *= 20.0  # one batch element sets most rows' scales
    ref = np.asarray(jvx.spmm(jplan, jnp.asarray(x), impl="int8"))
    out = vt.spmm(tplan, torch.from_numpy(x), impl="int8")
    assert tuple(out.shape) == (b, n, d)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("label", ["n512 d64 PlanConfig(32,128)", "gen_outlier_normal rows"])
def test_int8_without_bf16_rounding_misses_the_limit(label):
    """The parity limit has teeth: dequantizing in float32 (no bf16 scale,
    no bf16 product) moves the result well past rtol 1e-5, atol 1e-5."""
    indptr, indices, n, x, jplan, tplan = case_inputs(label)
    ref = np.asarray(spmm_pallas_int8(jplan, jnp.asarray(x)))
    q, scale = vt.quantize_rows(torch.from_numpy(x))
    xf = vt.dequantize_rows(q, scale)  # float32 throughout
    loose = block_sum(tplan, xf, clipped_gather(tplan, xf)).numpy()
    assert not np.allclose(loose, ref, **TOL)
    err = np.abs(loose - ref).max()
    assert err > 100 * (TOL["atol"] + TOL["rtol"] * np.abs(ref).max())
    # it is still inside the JAX package's oracle limit, which is why the
    # parity test is the tight one
    oracle = spmm_scipy(indptr, indices, n, x)
    assert np.linalg.norm(loose - oracle) / np.linalg.norm(oracle) < 3e-2


@pytest.mark.parametrize("n,density,d,limit,outliers", [
    (512, 0.05, 64, 2e-2, False),
    (300, 0.02, 130, 2e-2, False),
    (400, 0.04, 64, 3e-2, True),
])
def test_int8_close_to_scipy_oracle(n, density, d, limit, outliers):
    """tests/test_quant.py's accuracy limits against the exact product."""
    a = random_csr(n, density, seed=n)
    x = (tutils.gen_outlier_normal((n, d), outlier_frac=0.02, seed=1) if outliers
         else features(n, d, seed=d))
    tplan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(32, 128))
    out = vt.spmm(tplan, torch.from_numpy(x), impl="int8").numpy()
    oracle = spmm_scipy(a.indptr, a.indices, n, x)
    assert np.linalg.norm(out - oracle) / np.linalg.norm(oracle) < limit


@pytest.mark.parametrize("case", ["normal", "zero rows", "outliers", "d1", "ties"])
def test_quantize_rows_matches_jax(case):
    x = features(200, 33, seed=14) * 10
    if case == "zero rows":
        x[::4] = 0.0
    elif case == "outliers":
        x = jutils.gen_outlier_normal((200, 33), outlier_frac=0.05, seed=2)
    elif case == "d1":
        x = x[:, :1].copy()
    elif case == "ties":  # exact halves of the scale: round half to even
        x = np.tile(np.arange(-127, 128, 0.5, dtype=np.float32)[None, :], (3, 1))
        x[:, -1] = 127.0
    qj, sj = jquantize_rows(jnp.asarray(x))
    qt, st = vt.quantize_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and tuple(st.shape) == (x.shape[0], 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = vt.dequantize_rows(qt, st, tdt).float().numpy()
        want = np.asarray(jdequantize_rows(qj, sj, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_int8_refusals():
    n = 256
    a = random_csr(n, 0.05, seed=15)
    plan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(32, 128))
    x = torch.zeros(n, 8)
    weighted = dataclasses.replace(plan, values=torch.ones(plan.total_blocks, 32, 128))
    for fn in (spmm_int8, spmm_int8_reference):
        with pytest.raises(ValueError, match="value plane"):
            fn(weighted, x)
        with pytest.raises(ValueError, match="natural lane order"):
            fn(dataclasses.replace(plan, src_perm=torch.arange(n, dtype=torch.int32)), x)
        # bf16 rows are taken (tests/test_torch_bf16_weighted_int8.py), float16 not
        out = fn(plan, x.to(torch.bfloat16))
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (n, 8)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(plan, x.to(torch.float16))
    with pytest.raises(NotImplementedError, match="block_d"):
        vt.spmm(plan, x, impl="int8", block_d=128)
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm_int8(plan.to("meta"), torch.zeros(n, 8, device="meta"))


def test_spmm_int8_on_cpu_runs_the_plain_version():
    n, d = 300, 24
    a = random_csr(n, 0.05, seed=16)
    plan = vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(32, 128))
    x = torch.from_numpy(features(n, d, seed=17))
    launches, calls = spmm_int8.launches, spmm_int8_reference.calls
    out = spmm_int8(plan, x, out_dtype=torch.bfloat16)
    assert spmm_int8.launches == launches  # no kernel launch on the CPU
    assert spmm_int8_reference.calls == calls + 1
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, spmm_int8_reference(plan, x).to(torch.bfloat16))
    empty = vt.csr_preprocess(np.zeros(n + 1, np.int64), np.zeros(0, np.int64), n)
    assert not spmm_int8(empty, x).any()


def test_int8_kernel_source_builds_for_sm90a(tmp_path, monkeypatch):
    """K8 builds as the other kernels do: one nvcc call for its source,
    for sm_90a (an executable stands in for nvcc)."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then echo fake nvcc 0.0; exit 0; fi\n'
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv(vt.project.NVCC_FLAG, str(nvcc))
    monkeypatch.setenv(vt.project.BUILD_DIR_FLAG, str(tmp_path / "kernels"))
    monkeypatch.setattr(compiler, "runtime_cache", {})
    rt = compiler.build("spmm_int8", ["spmm_int8.cu"])
    assert os.path.basename(rt.path) == "libspmm_int8.so"
    cmd = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == os.path.join(compiler.CSRC_DIR, "spmm_int8.cu")


def test_gen_outlier_normal_matches_jax():
    for kw in (dict(), dict(outlier_frac=0.1, outlier_scale=7.0, seed=3)):
        got = tutils.gen_outlier_normal((50, 9), **kw)
        want = jutils.gen_outlier_normal((50, 9), **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _fp8_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# values past 448 and the rounding midpoint 464 above it, infinities, NaN
# of both signs, subnormals and zeros
FP8_EDGE = np.array([0.0, -0.0, 1.0, -1.0, 447.0, 448.0, 449.0, 463.9, 464.0, 464.1, 465.0,
                     479.0, 480.0, 1e4, -470.0, -1e30, np.inf, -np.inf, np.nan, -np.nan,
                     1e-9, 0.00195, 2.0 ** -9, 2.0 ** -10, 3.3e-3], np.float32)
FP8_EDGE[19] = -FP8_EDGE[18]  # a NaN with its sign bit set


def test_round_quant_fp8_matches_jax_past_448():
    rng = np.random.default_rng(18)
    for x in (FP8_EDGE, (rng.standard_normal(500) * 300).astype(np.float32)):
        got = tutils.round_quant_fp8(torch.from_numpy(x))
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_fp8_bits(got), _fp8_bits(jutils.round_quant_fp8(x)))
    # torch's own cast saturates where the JAX package's gives NaN: the
    # port maps those values explicitly
    assert torch.isnan(tutils.round_quant_fp8(torch.tensor([500.0, -np.inf]))
                       .float()).all()


@pytest.mark.parametrize("case", ["normal", "outliers", "with inf"])
def test_per_tensor_fp8_matches_jax(case):
    x = features(64, 32, seed=19) * 3
    if case == "outliers":
        x = jutils.gen_outlier_normal((64, 32), outlier_frac=0.05, seed=4)
    elif case == "with inf":
        x[3, 4] = np.inf
    qt, st = tutils.per_tensor_quant_fp8(torch.from_numpy(x))
    qj, sj = jutils.per_tensor_quant_fp8(x)
    np.testing.assert_array_equal(_fp8_bits(qt), _fp8_bits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    got = tutils.per_tensor_dequant_fp8(qt, st).numpy()
    want = np.asarray(jutils.per_tensor_dequant_fp8(qj, sj))
    np.testing.assert_array_equal(got, want)  # NaN where want is NaN (payloads aside)


@pytest.mark.parametrize("blk", [(128, 128), (32, 64)])
def test_block_fp8_matches_jax(blk):
    x = jutils.gen_outlier_normal((256, 128), outlier_frac=0.02, seed=5) * 40
    x[:32, :64] = 0.0  # an all-zero tile takes scale 1
    x[100, 5] = 1e6  # past 448 after scaling only where the tile's scale is small
    qt, st = tutils.block_quant_fp8(torch.from_numpy(x), blk)
    qj, sj = jutils.block_quant_fp8(x, blk)
    np.testing.assert_array_equal(_fp8_bits(qt), _fp8_bits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    got = tutils.block_dequant_fp8(qt, st, blk).numpy()
    want = np.asarray(jutils.block_dequant_fp8(qj, sj, blk))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError, match="tile"):
        tutils.block_quant_fp8(torch.zeros(100, 128), blk)

"""The tuner's bf16 variants against the JAX package on the CPU: the
`Variant` fields feat_dtype and compute_dtype, both default spaces' keys
under accurate=False against JAX's with the difference pinned,
`_run_variant` returning the caller's dtype, `estimate_residency`'s bf16
copy, the accurate marker of the cache signature, the probe on a bf16
variant, and a race of a bf16 space (tests/test_tuner.py:234's case).

The port's plain versions sum the bf16 rows in float32; JAX's kernels run
in interpret mode. Float32 results at tests/test_spmm.py:32-33's
tolerance; against the float64 oracle at bf16's class (relative error
<= 1e-2, the JAX test's bound).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.tuner.tuner as jtuner
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.tuner.tuner as ttuner
from voltrix_spmm_tpu.ops import spmm_scipy
from voltrix_spmm_tpu_torch.tuner import SpmmTuner, Variant, default_space, weighted_default_space
from voltrix_spmm_tpu_torch.utils import relative_error

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:32-33


@pytest.fixture
def problem():
    rng = np.random.default_rng(0)
    n, d = 256, 64
    a = sp.random(n, n, density=0.05, format="csr", random_state=rng)
    a.data[:] = 1.0
    feat = rng.standard_normal((n, d)).astype(np.float32)
    oracle = spmm_scipy(a.indptr, a.indices, n, feat).astype(np.float32)
    return a, feat, oracle


BF16_VARIANTS = [
    Variant("pregather", block_h=32, feat_dtype="bfloat16"),
    Variant("pregather", block_h=256, block_unroll=2, subtile=True, feat_dtype="bfloat16"),
    Variant("fused", block_h=32, gather_segment=8, compute_dtype="bfloat16"),
    Variant("hybrid", block_h=32, gather_segment=8, feat_dtype="bfloat16"),
    Variant("pregather", block_h=32, stream_chunks=2, feat_dtype="bfloat16"),
    Variant("ell", block_h=32, block_unroll=4, feat_dtype="bfloat16"),
    Variant("ell", block_h=32, block_unroll=4, stream_chunks=2, compute_dtype="bfloat16"),
]


def test_variant_bf16_fields():
    """feat_dtype and compute_dtype take "bfloat16" (the key is JAX's, with
    its /x marker for feat_dtype); "float16" now builds JAX's key too; K4 and
    K8 refuse a 16-bit compute_dtype, and a feat_dtype outside float32,
    bfloat16 and float16 is refused."""
    for v in BF16_VARIANTS:
        assert v.bf16
        assert v.key() == jtuner.Variant(**{k: getattr(v, k) for k in (
            "impl", "block_h", "gather_segment", "block_unroll", "subtile", "feat_dtype",
            "compute_dtype", "stream_chunks")}).key()
    assert "/xbfloat16/" in Variant("pregather", feat_dtype="bfloat16").key()
    assert not Variant("pregather", compute_dtype="float32").bf16
    for field in ("feat_dtype", "compute_dtype"):
        v = Variant("pregather", **{field: "float16"})
        assert v.half and not v.bf16
        assert v.key() == jtuner.Variant("pregather", **{field: "float16"}).key()
    for impl in ("int8", "weighted"):  # K4 and K8 take 16-bit rows, not compute_dtype
        assert Variant(impl, feat_dtype="bfloat16").bf16
        for dtype in ("bfloat16", "float16"):
            with pytest.raises(NotImplementedError, match="no compute_dtype"):
                Variant(impl, compute_dtype=dtype)
        with pytest.raises(NotImplementedError, match="float16"):
            Variant(impl, feat_dtype="float64")


# the difference with the JAX package's space, pinned: the port adds K1 on
# PlanConfig(128, 128) (float32 rows only); JAX adds K3's slots=3 twin (a
# TPU pipeline knob) and, where its gates pass, the bf16 packed and
# interleaved gather layouts (ROADMAP.md item 18)
PORT_ONLY = {Variant("pregather", block_h=128).key()}


@pytest.mark.parametrize("stats,jax_only", [
    (dict(d=128), {"fused/h2048w128s128u4p3/dNone/bfloat16/None/tNone"}),
    (dict(d=128, coverage128=1.75), set()),
    (dict(d=256, coverage128=0.9, coverage32=0.3), set()),
    (dict(d=16, coverage128=0.1, split_rows8=0.5, split_slots8=1.1),
     {"fused/h2048w128s128u4p3/dNone/bfloat16/None/tNone",
      "hybrid/h2048w128s8u8sthpik/xbfloat16/dNone/float32/None/tNone"}),
])
def test_default_space_bf16_keys_against_jax(stats, jax_only):
    """default_space(accurate=False) holds the JAX package's bf16 variants
    that the port runs: the set differences are pinned."""
    ours = {v.key() for v in default_space(**stats)}
    theirs = {v.key() for v in jtuner.default_space(accurate=False, **stats)}
    tall = Variant("hybrid", block_h=2048, gather_segment=8, block_unroll=8, subtile=True)
    port_only = PORT_ONLY | ({tall.key()} if "split_rows8" in stats else set())
    assert ours - theirs == port_only
    assert theirs - ours == jax_only
    bf16 = [v for v in default_space(**stats) if v.bf16]
    assert bf16 and all(v.impl in ("pregather", "fused") for v in bf16)
    # a compute_dtype variant and its feat_dtype twin run the same kernel on
    # the same bytes: one of each races, the JAX space's
    assert all(v.compute_dtype == "bfloat16" for v in bf16 if v.impl == "fused")
    assert all(v.feat_dtype == "bfloat16" for v in bf16 if v.impl == "pregather")
    assert not any(v.bf16 for v in default_space(accurate=True, **stats))


def test_huge_default_space_budgets_bf16_variants():
    """Past 4 GiB of edge features the bf16 variants are budgeted with the
    others, their residency counting the bf16 copy of the features."""
    stats = dict(d=256, nnz=79_000_000, num_nodes=132_534, coverage128=0.3,
                 gather_rows=30_000_000, gather_rows_2048=12_000_000)
    res = {}
    whole = default_space(device_mem_bytes=64e9, residency=res, **stats)
    bf16 = [v for v in whole if v.bf16]
    assert bf16 and set(res) == {v.key() for v in whole}
    for v in bf16:
        twin = Variant(v.impl, v.block_h, v.block_w, v.gather_segment,
                       block_unroll=v.block_unroll, subtile=v.subtile)
        if twin.key() in res:
            assert res[v.key()] - res[twin.key()] == pytest.approx(2 * 132_534 * 256)


def test_weighted_default_space_bf16_keys_against_jax():
    """weighted_default_space(accurate=False) adds JAX's bf16 twins of K6 at
    128 and 256 rows: the same keys as JAX's space; past 4 GiB they chunk
    with the others."""
    for slots in (4.0, 100.0):
        ours = {v.key() for v in weighted_default_space(d=256, nnz=100_000,
                                                        dense_slots_per_nnz=slots)}
        theirs = {v.key() for v in jtuner.weighted_default_space(
            d=256, nnz=100_000, dense_slots_per_nnz=slots)}
        assert ours == theirs
        assert ({v.key() for v in weighted_default_space(d=256, nnz=100_000, accurate=True,
                                                         dense_slots_per_nnz=slots)}
                == {k for k in ours if "bfloat16" not in k})
    tight = weighted_default_space(d=1024, nnz=40_000_000, num_nodes=20_000,
                                   device_mem_bytes=0.9e9)
    assert {(v.block_h, v.feat_dtype) for v in tight if v.bf16} == {(128, "bfloat16"),
                                                                    (256, "bfloat16")}
    assert all(v.stream_chunks == 4 for v in tight)


def test_estimate_residency_counts_the_bf16_copy():
    f32 = Variant("pregather", block_h=128)
    kw = dict(num_nodes=1000, d=64, nnz=10_000, lanes=10_000)
    for v in (Variant("pregather", block_h=128, feat_dtype="bfloat16"),
              Variant("pregather", block_h=128, compute_dtype="bfloat16")):
        assert (ttuner.estimate_residency(v, **kw) - ttuner.estimate_residency(f32, **kw)
                == 2 * 1000 * 64)


def _plan(variant, a):
    return ttuner.build_variant_plan(variant, a.indptr, a.indices, a.shape[0], None,
                                     device="cpu")


@pytest.mark.parametrize("variant", BF16_VARIANTS, ids=lambda v: v.key())
def test_run_variant_returns_the_callers_dtype(problem, variant):
    """The port's mirror of tests/test_spmm.py:270-281: a bf16 variant's
    result comes back in the caller's float32, at bf16's class against the
    float64 oracle, and as JAX's _run_variant gives it (the float32 sums of
    the same bf16 rows)."""
    a, feat, oracle = problem
    out = ttuner._run_variant(variant, _plan(variant, a), torch.from_numpy(feat))
    assert out.dtype == torch.float32
    assert vt.calc_diff(out.numpy(), oracle) < 1e-2
    jv = jtuner.Variant(**{k: getattr(variant, k) for k in (
        "impl", "block_h", "gather_segment", "block_unroll", "subtile", "feat_dtype",
        "compute_dtype", "stream_chunks")})
    jplan = jtuner.build_variant_plan(jv, a.indptr, a.indices, a.shape[0], None)
    want = jtuner._run_variant(jv, jplan, jnp.asarray(feat))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    # bf16 outputs stay bf16
    assert ttuner._run_variant(variant, _plan(variant, a),
                               torch.from_numpy(feat).to(torch.bfloat16)).dtype == torch.bfloat16


def test_feat_dtype_variant_accuracy(problem, tmp_path):
    """tests/test_tuner.py:234's case on the port: a race of a bf16 space
    returns the caller's dtype within bf16's accuracy class."""
    a, feat, oracle = problem
    tuned = SpmmTuner(cache_dir=str(tmp_path)).compile_and_tune(
        a.indptr, a.indices, a.shape[0], feat, iters=1, device="cpu",
        space=[Variant("pregather", block_h=32, feat_dtype="bfloat16")])
    out = tuned(torch.from_numpy(feat))
    assert out.dtype == torch.float32
    assert relative_error(oracle, out.numpy()) <= 1e-2
    jtuned = jtuner.SpmmTuner(cache_dir=str(tmp_path / "jax")).compile_and_tune(
        a.indptr, a.indices, a.shape[0], feat, iters=1,
        space=[jtuner.Variant("pregather", block_h=32, feat_dtype="bfloat16")])
    assert list(tuned.candidates) == list(jtuned.candidates)
    np.testing.assert_allclose(out.numpy(), np.asarray(jtuned(jnp.asarray(feat))), **TOL)


def test_accurate_is_part_of_the_default_space_signature(problem, tmp_path):
    """The default space differs by `accurate` (the bf16 variants join under
    accurate=False), so its cache entry does: an "A" marks accurate=True."""
    a, feat, _ = problem
    tuner = SpmmTuner(cache_dir=str(tmp_path))
    kw = dict(iters=1, device="cpu", hash_tag="g", budget_s=0.0)
    fast = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, **kw)
    accurate = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, accurate=True, **kw)
    assert fast is not accurate
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("tune.g."))
    assert len(names) == 2 and sum(".float32.cpuA." in f for f in names) == 1
    # budget 0: the first candidate races, the rest are skipped
    assert len(fast.candidates) == len(accurate.candidates) == 1


def test_probe_runs_a_bf16_variant():
    """The isolated probe builds a bf16 variant's plan from its spec and
    times it (in process here; the tuner starts it in a process of its own)."""
    import dataclasses
    import tempfile

    from voltrix_spmm_tpu_torch.tuner import probe

    a = sp.random(200, 200, density=0.05, format="csr", random_state=np.random.default_rng(3))
    with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as f:
        np.savez(f, indptr=a.indptr, indices=a.indices)
    try:
        spec = {"csr": f.name, "num_nodes": 200, "d": 16, "feat_dtype": "float32",
                "variant": dataclasses.asdict(Variant("pregather", block_h=32,
                                                      feat_dtype="bfloat16")),
                "ordering": "identity", "iters": 1, "backend": "auto", "device": "cpu"}
        out = probe.run_probe(spec, {})
    finally:
        os.unlink(f.name)
    assert out["ok"] and out["time_ms"] > 0

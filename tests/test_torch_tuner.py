"""The port's SpMM autotuner (voltrix_spmm_tpu_torch/tuner) against the JAX
package's on the CPU, after tests/test_tuner.py: the same numpy graphs and
features go through `SpmmTuner` of both packages. On CPU tensors the port
races its kernels' plain versions (timed by `CPU_bench`); the JAX side
runs its Pallas kernels in interpret mode. Tuned products are held to
JAX's `spmm_scipy` and to JAX's tuned products at tests/test_spmm.py:32-33's
tolerance (rtol 1e-5, atol 1e-4), weighted ones at tests/test_tuner.py's
(rtol 1e-4, atol 1e-3). Every race uses a cache directory of its own
(tmp_path). The isolated probe starts a process a candidate."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu as jvx
import voltrix_spmm_tpu.format.preprocess as jprep
import voltrix_spmm_tpu.models.graph as jgraph
import voltrix_spmm_tpu.tuner.tuner as jtuner
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.format.preprocess as tprep
import voltrix_spmm_tpu_torch.tuner.tuner as ttuner
from voltrix_spmm_tpu.ops import spmm_scipy
from voltrix_spmm_tpu_torch.data import chung_lu_csr, erdos_renyi_csr, symmetrize
from voltrix_spmm_tpu_torch.models.graph import (
    AUTO_FUSED_MIN_NODES,
    auto_plan_config,
    auto_stream_chunks,
)
from voltrix_spmm_tpu_torch.tuner import SpmmTuner, Variant, default_space, weighted_default_space

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:32-33
WTOL = dict(rtol=1e-4, atol=1e-3)  # tests/test_tuner.py's weighted products


def tiny_space():
    return [Variant("pregather", block_h=32), Variant("fused", block_h=32, gather_segment=8)]


@pytest.fixture
def problem(rng):
    n, d = 256, 64
    a = sp.random(n, n, density=0.05, format="csr", random_state=rng)
    feat = rng.standard_normal((n, d)).astype(np.float32)
    oracle = spmm_scipy(a.indptr, a.indices, n, feat).astype(np.float32)
    return a, feat, oracle


def tune(tmp_path, a, feat, **kw):
    kw.setdefault("iters", 1)
    return SpmmTuner(cache_dir=str(tmp_path)).compile_and_tune(
        a.indptr, a.indices, a.shape[0], feat, device="cpu", **kw)


def run(tuned, feat):
    return tuned(torch.from_numpy(feat)).numpy()


# ---- tests/test_tuner.py, case for case -----------------------------------


def test_tuned_result_correct(problem, tmp_path):
    a, feat, oracle = problem
    tuned = tune(tmp_path, a, feat, space=tiny_space())
    np.testing.assert_allclose(run(tuned, feat), oracle, **TOL)
    assert tuned.time_ms > 0 and len(tuned.candidates) == 2
    assert set(tuned.plan_seconds) == set(tuned.candidates) and not tuned.errors


def test_memory_and_disk_cache(problem, tmp_path):
    a, feat, oracle = problem
    tuner = SpmmTuner(cache_dir=str(tmp_path))
    kw = dict(space=tiny_space(), iters=1, device="cpu")
    t1 = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, **kw)
    assert tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, **kw) is t1
    entries = [f for f in os.listdir(tmp_path) if f.startswith("tune.")]
    assert len(entries) == 1
    fresh = SpmmTuner(cache_dir=str(tmp_path))
    t3 = fresh.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, **kw)
    assert t3 is not t1 and t3.variant == t1.variant
    assert t3.candidates == t1.candidates and t3.plan_seconds == t1.plan_seconds
    np.testing.assert_allclose(run(t3, feat), oracle, **TOL)


def test_disk_hit_times_nothing(problem, tmp_path, monkeypatch):
    a, feat, _ = problem
    tune(tmp_path, a, feat, space=tiny_space())

    def boom(*_a, **_k):
        raise AssertionError("a disk hit timed a candidate")

    monkeypatch.setattr(ttuner, "_bench", boom)
    tuned = tune(tmp_path, a, feat, space=tiny_space())
    assert len(tuned.candidates) == 2


def test_invalid_candidate_skipped(problem, tmp_path):
    a, feat, _ = problem
    space = [Variant("pregather", block_h=32), Variant("fused", block_h=32, gather_segment=1)]
    tuned = tune(tmp_path, a, feat, space=space)
    assert tuned.variant.impl == "pregather"
    key = "identity|fused/h32w128s1u1/dNone/float32/None/tNone"  # the JAX package's key
    assert tuned.candidates[key] == float("inf")
    assert tuned.errors[key].startswith("ValueError") and "gather_segment" in tuned.errors[key]


def test_all_candidates_invalid_raises(problem, tmp_path):
    a, feat, _ = problem
    with pytest.raises(RuntimeError, match="no valid tuning candidate"):
        tune(tmp_path, a, feat, space=[Variant("fused", block_h=32)])


def test_launch_failure_stops_the_race(problem, tmp_path, monkeypatch):
    """A failure other than a refusal or out-of-memory (a launch that breaks
    the CUDA context) stops the race with its message: no candidate is
    marked inf and passed over."""
    a, feat, _ = problem
    real = ttuner._run_variant

    def broken(variant, *args):
        if variant.impl == "fused":
            raise RuntimeError("spmm_fused launch failed: an illegal memory access")
        return real(variant, *args)

    monkeypatch.setattr(ttuner, "_run_variant", broken)
    with pytest.raises(RuntimeError, match="the race stops.*illegal memory access"):
        tune(tmp_path, a, feat, space=tiny_space())
    assert not any(f.startswith("tune.") and f.endswith(".json") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("err,invalid", [
    (ValueError("geometry"), True),
    (torch.cuda.OutOfMemoryError("out of memory"), True),
    (RuntimeError("launch failed"), False),
    (TypeError("dtype"), False),
])
def test_candidate_invalid_classifies_failures(err, invalid):
    assert ttuner.candidate_invalid(err) is invalid


def test_hash_tag_controls_signature(problem, tmp_path):
    a, feat, _ = problem
    tune(tmp_path, a, feat, space=tiny_space(), hash_tag="mygraph")
    entries = [f for f in os.listdir(tmp_path) if f.startswith("tune.mygraph")]
    assert len(entries) == 1
    payload = json.load(open(os.path.join(tmp_path, entries[0])))
    assert {"variant", "candidates", "plan_seconds", "ordering"} <= set(payload)


def test_hash_tag_skips_content_hash(problem, tmp_path, monkeypatch):
    a, feat, _ = problem

    def boom(*_a, **_k):
        raise AssertionError("_matrix_hash called despite hash_tag")

    monkeypatch.setattr(ttuner, "_matrix_hash", boom)
    tuner = SpmmTuner(cache_dir=str(tmp_path))
    kw = dict(space=tiny_space()[:1], hash_tag="tagged", iters=1, device="cpu")
    t1 = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, **kw)
    assert tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, **kw) is t1


def test_reordering_selection(problem, tmp_path):
    a, feat, oracle = problem
    kw = dict(space=tiny_space()[:1], reorderings=("identity", "rcm", "degree"))
    tuned = tune(tmp_path, a, feat, **kw)
    assert len(tuned.candidates) == 3 and tuned.ordering in ("identity", "rcm", "degree")
    np.testing.assert_allclose(run(tuned, feat), oracle, **TOL)
    t2 = tune(tmp_path, a, feat, **kw)  # a disk hit keeps the ordering
    assert t2.ordering == tuned.ordering
    np.testing.assert_allclose(run(t2, feat), oracle, **TOL)


def test_budget_early_stop(problem, tmp_path):
    """A zero budget times the first candidate (a winner is needed) and
    skips the rest."""
    a, feat, oracle = problem
    tuned = tune(tmp_path, a, feat, space=tiny_space(), budget_s=0.0)
    assert len(tuned.candidates) == 1
    np.testing.assert_allclose(run(tuned, feat), oracle, **TOL)


def test_budget_from_environment(problem, tmp_path, monkeypatch):
    a, feat, _ = problem
    monkeypatch.setenv("VOLTRIX_TORCH_TUNE_BUDGET_S", "0")
    assert len(tune(tmp_path, a, feat, space=tiny_space()).candidates) == 1


@pytest.mark.parametrize("parallel_compile", [False, True])
def test_serial_and_parallel_compile(problem, tmp_path, parallel_compile):
    """Both paths race every candidate; K1 and K8 on one config share a
    plan (`_variant_plan_key`), built once in parallel mode."""
    a, feat, oracle = problem
    space = tiny_space() + [Variant("fused", block_h=32), Variant("int8", block_h=32)]
    tuned = tune(tmp_path, a, feat, space=space, parallel_compile=parallel_compile,
                 reorderings=("identity", "degree"))
    assert len(tuned.candidates) == 8 and len(tuned.errors) == 2
    assert ttuner._variant_plan_key(space[0]) == ttuner._variant_plan_key(space[3])
    if tuned.variant.impl != "int8":
        np.testing.assert_allclose(run(tuned, feat), oracle, **TOL)


def test_weighted_tuning_correct(problem, tmp_path):
    a, feat, _ = problem
    vals = np.random.default_rng(5).standard_normal(a.nnz).astype(np.float32)
    aw = sp.csr_matrix((vals, a.indices, a.indptr), shape=a.shape)
    space = [Variant("ell", block_h=64, block_unroll=2), Variant("ell", block_h=128),
             Variant("weighted", block_h=64)]
    tuned = tune(tmp_path, a, feat, space=space, values=vals)
    np.testing.assert_allclose(run(tuned, feat), aw @ feat, **WTOL)
    assert tuned.variant.impl in ("ell", "weighted") and len(tuned.candidates) == 3


def test_weighted_tuning_rejects_binary_variants(problem, tmp_path):
    a, feat, _ = problem
    with pytest.raises(RuntimeError, match="no valid tuning candidate"):
        tune(tmp_path, a, feat, space=[Variant("pregather", block_h=32)],
             values=np.ones(a.nnz, np.float32))


def test_weighted_signature_distinct(problem, tmp_path):
    a, feat, _ = problem
    tune(tmp_path, a, feat, space=[Variant("pregather", block_h=32)], hash_tag="g")
    tune(tmp_path, a, feat, space=[Variant("ell", block_h=64, block_unroll=2)], hash_tag="g",
         values=np.ones(a.nnz, np.float32))
    entries = [f for f in os.listdir(tmp_path) if f.startswith("tune.g")]
    assert len(entries) == 2 and sum(".w." in f for f in entries) == 1, entries


def test_weighted_tuning_with_reordering(problem, tmp_path):
    a, feat, _ = problem
    vals = np.random.default_rng(9).standard_normal(a.nnz).astype(np.float32)
    aw = sp.csr_matrix((vals, a.indices, a.indptr), shape=a.shape)
    tuned = tune(tmp_path, a, feat, space=[Variant("ell", block_h=64, block_unroll=2)],
                 values=vals, reorderings=("identity", "degree"))
    np.testing.assert_allclose(run(tuned, feat), aw @ feat, **WTOL)


def test_weighted_default_space_shapes():
    small = weighted_default_space(d=256, nnz=100_000, dense_slots_per_nnz=4.0)
    assert {v.impl for v in small} == {"ell", "weighted"}
    sparse = weighted_default_space(d=256, nnz=100_000, dense_slots_per_nnz=100.0)
    assert {v.impl for v in sparse} == {"ell"}
    # past 4 GiB of edge features K4 leaves; K6's plan fits an 80 GB card whole
    huge = weighted_default_space(d=1024, nnz=40_000_000, dense_slots_per_nnz=4.0,
                                  num_nodes=2_000_000, device_mem_bytes=64e9)
    assert {v.impl for v in huge} == {"ell"} and not any(v.stream_chunks for v in huge)
    # a dense graph (2,000 edges a node) on a small budget: only window chunks
    # fit (one chunk's row pieces at a time), and they join in place of the
    # whole plans; on a smaller one nothing fits
    tight = weighted_default_space(d=1024, nnz=40_000_000, num_nodes=20_000,
                                   device_mem_bytes=0.9e9)
    assert tight and all(v.stream_chunks == 4 for v in tight)
    assert weighted_default_space(d=1024, nnz=40_000_000, num_nodes=20_000,
                                  device_mem_bytes=0.5e9) == []


def test_weighted_memory_cache_fresh_values(problem, tmp_path):
    a, feat, _ = problem
    rng = np.random.default_rng(11)
    v1, v2 = (rng.standard_normal(a.nnz).astype(np.float32) for _ in range(2))
    tuner = SpmmTuner(cache_dir=str(tmp_path))
    kw = dict(space=[Variant("ell", block_h=64, block_unroll=2)], iters=1, hash_tag="vals",
              device="cpu")
    t1 = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, values=v1, **kw)
    t2 = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, values=v2, **kw)
    for t, v in ((t1, v1), (t2, v2)):
        aw = sp.csr_matrix((v, a.indices, a.indptr), shape=a.shape)
        np.testing.assert_allclose(run(t, feat), aw @ feat, **WTOL)
    assert tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], feat, values=v2, **kw) is t2


def test_explicit_space_is_part_of_cache_identity(problem, tmp_path):
    a, feat, oracle = problem
    space_a = [Variant("pregather", block_h=128, block_unroll=2)]
    assert len(tune(tmp_path, a, feat, space=space_a).candidates) == 1
    space_b = space_a + [Variant("pregather", block_h=256, block_unroll=2)]
    t2 = tune(tmp_path, a, feat, space=space_b)
    assert len(t2.candidates) == 2
    t3 = tune(tmp_path, a, feat, space=space_b)
    assert set(t3.candidates) == set(t2.candidates)
    np.testing.assert_allclose(run(t2, feat), oracle, **TOL)


def test_cache_directory_from_environment(problem, tmp_path, monkeypatch):
    a, feat, _ = problem
    monkeypatch.setenv("VOLTRIX_TORCH_CACHE_DIR", str(tmp_path / "env"))
    SpmmTuner().compile_and_tune(a.indptr, a.indices, a.shape[0], feat, space=tiny_space(),
                                 iters=1, device="cpu")
    assert any(f.startswith("tune.") for f in os.listdir(tmp_path / "env"))


def test_isolated_probe_tuning(problem, tmp_path):
    """isolate=True times each candidate in a process of its own; an invalid
    candidate is skipped there too."""
    a, feat, oracle = problem
    space = tiny_space() + [Variant("fused", block_h=32)]
    tuned = tune(tmp_path, a, feat, space=space, isolate=True, probe_timeout_s=120.0)
    assert len(tuned.candidates) == 3
    finite = {k: v for k, v in tuned.candidates.items() if np.isfinite(v)}
    assert len(finite) == 2 and set(tuned.plan_seconds) == set(tuned.candidates)
    assert list(tuned.errors.values())[0].startswith("ValueError")
    np.testing.assert_allclose(run(tuned, feat), oracle, **TOL)


def test_partial_race_resume(problem, tmp_path):
    a, feat, oracle = problem
    t1 = tune(tmp_path, a, feat, space=tiny_space())
    assert not any(f.endswith(".partial") for f in os.listdir(tmp_path))
    (disk,) = [f for f in os.listdir(tmp_path) if f.startswith("tune.")]
    fake_key = sorted(t1.candidates)[0]
    with open(os.path.join(tmp_path, disk + ".partial"), "w") as f:
        json.dump({"results": {fake_key: 1e-6}}, f)
    os.unlink(os.path.join(tmp_path, disk))
    t2 = tune(tmp_path, a, feat, space=tiny_space())
    assert t2.time_ms == 1e-6 and f"identity|{t2.variant.key()}" == fake_key
    assert len(t2.candidates) == 2 and all(np.isfinite(v) for v in t2.candidates.values())
    assert not any(f.endswith(".partial") for f in os.listdir(tmp_path))
    np.testing.assert_allclose(run(t2, feat), oracle, **TOL)


# ---- the default space -----------------------------------------------------


def test_default_space_shapes():
    """accurate=True is the float32 variants of the default space, in its
    order (accurate=False adds the bf16 ones, tests/test_torch_bf16_tuner.py)."""
    space = default_space()
    assert all(isinstance(v, Variant) for v in space)
    assert [v.key() for v in default_space(accurate=True)] == [v.key() for v in space
                                                              if not v.bf16]
    keys = {v.key() for v in space}
    for v in (Variant("pregather", block_h=128),
              Variant("pregather", block_h=2048, block_unroll=4, subtile=True),
              Variant("hybrid", block_h=128, gather_segment=8),
              Variant("fused", block_h=2048, gather_segment=128, block_unroll=4)):
        assert v.key() in keys
    assert not any(v.impl == "int8" for d in (128, 256, 1024) for v in default_space(d=d))


def test_default_space_holds_only_what_the_port_runs():
    """Every default variant is in JAX's accurate space, but K1 on
    PlanConfig(128, 128), which JAX's space lacks, and the tall hybrid, whose
    dense side is K3 on the port (JAX's reads packed super-rows, item 18)."""
    stats = dict(d=16, coverage128=0.1, split_rows8=0.5, split_slots8=1.1)
    jspace = jtuner.default_space(accurate=True, **stats)
    ours = default_space(accurate=True, **stats)
    extra = {v.key() for v in ours} - {v.key() for v in jspace}
    tall = Variant("hybrid", block_h=2048, gather_segment=8, block_unroll=8, subtile=True)
    assert extra == {Variant("pregather", block_h=128).key(), tall.key()}
    (jtall,) = [v for v in jspace if v.impl == "hybrid" and v.block_h == 2048]
    assert (jtall.hybrid_dense, jtall.ipack) == ("pregather", True)


def test_default_space_coverage_gate():
    dense = default_space(d=256, coverage128=0.1)
    assert dense[0].impl == "fused" and dense[0].gather_segment == 128
    scattered = default_space(d=256, coverage128=1.75, coverage32=1.2)
    assert not any(v.impl == "fused" for v in scattered)
    assert any(v.impl == "fused" for v in default_space(d=256))
    mid = default_space(d=256, coverage128=0.9, coverage32=0.3)
    assert any(v.impl == "fused" and v.gather_segment == 32 for v in mid)
    assert not any(v.gather_segment == 128 for v in mid)


@pytest.mark.parametrize("rows,slots,joins", [(0.5, 1.2, True), (0.8, 1.2, False),
                                              (0.5, 1.5, False), (None, None, False)])
def test_default_space_tall_hybrid_gate(rows, slots, joins):
    space = default_space(d=128, split_rows8=rows, split_slots8=slots)
    tall = [v for v in space if v.impl == "hybrid" and v.block_h == 2048]
    assert bool(tall) == joins
    if tall:
        assert (tall[0].gather_segment, tall[0].block_unroll, tall[0].subtile) == (8, 8, True)


def test_huge_default_space_budgets_residency():
    """Past 4 GiB of edge features the hybrids leave (their host split) and
    each other candidate is held to the device budget: all fit a large
    budget whole; on a small one pregather joins in
    the fewest window chunks that fit, others leave; the estimates are kept."""
    stats = dict(d=256, nnz=79_000_000, num_nodes=132_534, coverage128=0.3,
                 gather_rows=30_000_000, gather_rows_2048=12_000_000)
    big, small = {}, {}
    whole = default_space(device_mem_bytes=64e9, residency=big, **stats)
    assert [v.key() for v in whole] == [v.key() for v in default_space(**{**stats, "d": 8})
                                        if v.impl != "hybrid"]
    assert not any(v.stream_chunks for v in whole) and set(big) == {v.key() for v in whole}
    tight = default_space(device_mem_bytes=8e9, residency=small, **stats)
    assert tight and all(small[v.key()] <= 8e9 for v in tight)
    assert any(v.stream_chunks for v in tight) and not any(v.impl == "fused" for v in tight)
    assert all(v.impl == "pregather" for v in tight if v.stream_chunks)
    assert len(tight) < len(whole)


def test_estimate_residency_counts_plan_workspace_and_features():
    v = Variant("pregather", block_h=128)
    base = ttuner.estimate_residency(v, num_nodes=1000, d=64, nnz=10_000, lanes=10_000)
    plan = 10_000 * (128 / 8 + 4)
    assert base > plan + 2 * 1000 * 64 * 4
    chunked = ttuner.estimate_residency(v, num_nodes=1000, d=64, nnz=10_000, lanes=10_000,
                                        chunks=4)
    assert chunked - 1000 * 64 * 4 < base  # a quarter of the workspace, one more output


# ---- identities with the JAX package ----------------------------------------


@pytest.mark.parametrize("n,edges,seed", [(300, 900, 0), (50_000, 400_000, 1)])
def test_matrix_and_values_hash_equal_jax(n, edges, seed):
    a = symmetrize(chung_lu_csr(n, edges, seed=seed))
    assert ttuner._matrix_hash(a.indptr, a.indices, n) == jtuner._matrix_hash(
        a.indptr, a.indices, n)
    vals = np.random.default_rng(seed).standard_normal(a.nnz).astype(np.float32)
    assert ttuner._values_hash(vals) == jtuner._values_hash(vals)


@pytest.mark.parametrize("block_h,q,thresh", [(2048, 8, None), (512, 4, None), (128, 8, 3)])
def test_density_split_stats_equal_jax(block_h, q, thresh):
    a = symmetrize(chung_lu_csr(3000, 20_000, seed=2))
    args = (a.indptr, a.indices, a.shape[0], block_h, q, thresh)
    assert tprep.density_split_stats(*args) == jprep.density_split_stats(*args)
    empty = (np.zeros(11, np.int64), np.zeros(0, np.int64), 10, block_h, q)
    assert tprep.density_split_stats(*empty) == jprep.density_split_stats(*empty) == (1.0, 1.0)


@pytest.mark.parametrize("kind", ["dense", "scattered", "empty"])
def test_fused_auto_config_equal_jax(kind):
    if kind == "dense":
        a = (sp.random(4096, 4096, density=0.08, format="csr", random_state=0) != 0).tocsr()
    elif kind == "scattered":
        a = symmetrize(chung_lu_csr(60_000, 120_000, seed=3))
    else:
        a = sp.csr_matrix((500, 500), dtype=np.float32)
    got = tprep.fused_auto_config(a.indptr, a.indices, a.shape[0])
    want = jprep.fused_auto_config(a.indptr, a.indices, a.shape[0])
    assert (got is None) == (want is None) == (kind == "scattered")
    if got is not None:
        assert dataclass_fields(got) == dataclass_fields(want)
    assert tprep.FUSED_COVERAGE_THRESHOLD == jprep.FUSED_COVERAGE_THRESHOLD


def dataclass_fields(cfg):
    return tuple(getattr(cfg, f) for f in ("block_h", "block_w", "gather_segment",
                                           "block_unroll", "cluster_cols"))


ONE_VARIANT = {
    "pregather": Variant("pregather", block_h=64, block_unroll=2),
    "pregather subtile": Variant("pregather", block_h=128, block_unroll=2, subtile=True),
    "pregather chunks": Variant("pregather", block_h=32, stream_chunks=3),
    "fused": Variant("fused", block_h=64, gather_segment=16, block_unroll=2),
    "hybrid": Variant("hybrid", block_h=128, gather_segment=8),
    "int8": Variant("int8", block_h=64),
    "ell": Variant("ell", block_h=64, block_unroll=2),
    "ell chunks": Variant("ell", block_h=32, stream_chunks=3),
    "weighted": Variant("weighted", block_h=64),
}


@pytest.mark.parametrize("name,ordering", [(name, "identity") for name in ONE_VARIANT] + [
    ("pregather", "rcm"), ("fused", "degree"), ("ell", "rcm"), ("ell", "degree")])
def test_one_variant_space_matches_jax_tuned(problem, tmp_path, name, ordering):
    """A one-variant space in both packages: the port's TunedSpmm(feat) equals
    JAX's TunedSpmm(feat) (ordering applied), weighted ones with values."""
    a, feat, oracle = problem
    v = ONE_VARIANT[name]
    vals = None
    if v.impl in ("ell", "weighted"):
        vals = np.random.default_rng(4).standard_normal(a.nnz).astype(np.float32)
    kw = dict(space=[v], iters=1, reorderings=(ordering,), values=vals)
    ours = tune(tmp_path / "torch", a, feat, **kw)
    theirs = jtuner.SpmmTuner(cache_dir=str(tmp_path / "jax")).compile_and_tune(
        a.indptr, a.indices, a.shape[0], feat, space=[jtuner.Variant(**dataclasses.asdict(v))],
        iters=1, reorderings=(ordering,), values=vals)
    assert ours.ordering == theirs.ordering == ordering
    assert list(ours.candidates) == list(theirs.candidates)
    got, want = run(ours, feat), np.asarray(theirs(jnp.asarray(feat)))
    tol = WTOL if vals is not None else TOL
    np.testing.assert_allclose(got, want, **tol)
    if vals is None and v.impl != "int8":
        np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("field,value", [
    ("feat_dtype", "bfloat16"), ("compute_dtype", "bfloat16"), ("block_d", 128),
    ("slots", 3), ("precision", "highest"), ("pack_order", "incidence"), ("ipack", True),
    ("hybrid_dense", "pregather"),
])
def test_tpu_only_variant_fields_raise(field, value):
    """The TPU-only fields raise; feat_dtype and compute_dtype "bfloat16"
    and "float16", refused until the kernels read 16-bit rows, now build the
    JAX package's variant (the same key) and refuse a type neither package
    names ("float64")."""
    if field in ("feat_dtype", "compute_dtype"):
        v = Variant("pregather", **{field: value})
        assert v.bf16 and v.key() == jtuner.Variant("pregather", **{field: value}).key()
        h = Variant("pregather", **{field: "float16"})
        assert h.half and h.key() == jtuner.Variant("pregather", **{field: "float16"}).key()
        with pytest.raises(NotImplementedError, match=field):
            Variant("pregather", **{field: "float64"})
        return
    with pytest.raises(NotImplementedError, match=field):
        Variant("pregather", **{field: value})


def test_variant_key_and_fields_match_jax():
    v = Variant("hybrid", block_h=2048, gather_segment=8, block_unroll=8, subtile=True)
    j = jtuner.Variant(**dataclasses.asdict(v))
    assert v.key() == j.key() and v.plan_config.block_h == j.plan_config.block_h
    with pytest.raises(ValueError, match="impl"):
        Variant("pallas")


def test_code_version_covers_csrc():
    files = ttuner._code_files()
    names = {os.path.relpath(f, os.path.dirname(ttuner.__file__)) for f in files}
    csrc = os.path.join(os.path.dirname(os.path.dirname(ttuner.__file__)), "csrc")
    want = {os.path.join("..", "csrc", f) for f in os.listdir(csrc)
            if f.endswith((".cu", ".cuh", ".hpp"))}
    assert want and want <= names
    assert os.path.join("..", "ops", "block_spmm.py") in names and "tuner.py" in names
    import hashlib

    md5 = hashlib.md5()
    for f in files:
        md5.update(open(f, "rb").read())
    assert ttuner._code_version() == md5.hexdigest()[:12]


# ---- build_graph(config="auto") and the command ---------------------------


K3_AUTO = vt.PlanConfig(2048, 128, gather_segment=128, block_unroll=4)


def dense_uniform(n: int, seed: int = 0):
    """A uniform graph (n / 512 edges a row) whose h2048 / seg128 coverage
    passes the gate."""
    rng = np.random.default_rng(seed)
    m = n * n // 512
    a = sp.csr_matrix((np.ones(m, np.float32), (rng.integers(0, n, m), rng.integers(0, n, m))),
                      shape=(n, n))
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


@pytest.mark.parametrize("n,want", [(AUTO_FUSED_MIN_NODES, K3_AUTO),
                                    (AUTO_FUSED_MIN_NODES - 1, vt.PlanConfig()),
                                    (4096, vt.PlanConfig())])
def test_auto_plan_config_dense_uniform(n, want):
    """A dense uniform graph passes the coverage gate at every size, as in
    JAX (which takes K3's plan for each); the port takes it from
    AUTO_FUSED_MIN_NODES rows on and K1's default plan below."""
    a = dense_uniform(n)
    k3 = jvx.PlanConfig(**dataclasses.asdict(K3_AUTO))
    assert jprep.fused_auto_config(a.indptr, a.indices, n) == k3
    assert auto_plan_config(a.indptr, a.indices, n) == want


def test_auto_plan_config_rule():
    """A power-law graph of >= 4096 nodes fails the gate: JAX sends it to K2
    on clustered 2048-row windows, the port to PlanConfig() (K1 on 128 rows
    won A's race); a tiny graph takes PlanConfig() in both."""
    big = symmetrize(chung_lu_csr(60_000, 120_000, seed=4))
    assert auto_plan_config(big.indptr, big.indices, big.shape[0]) == vt.PlanConfig()
    assert jgraph.auto_plan_config(big.indptr, big.indices, big.shape[0]).block_h == 2048
    tiny = symmetrize(erdos_renyi_csr(600, 0.001, seed=5))
    assert auto_plan_config(tiny.indptr, tiny.indices, 600) == vt.PlanConfig()
    assert jgraph.auto_plan_config(tiny.indptr, tiny.indices, 600) == jvx.PlanConfig()


def test_auto_stream_chunks_only_when_the_plan_does_not_fit():
    a = symmetrize(chung_lu_csr(2000, 10_000, seed=6))
    plan = vt.csr_preprocess(a.indptr, a.indices, 2000, vt.PlanConfig(128, 128))
    assert auto_stream_chunks(plan, a.nnz, device_mem_bytes=8e9) is None
    whole = ttuner.estimate_residency(Variant("pregather"), num_nodes=2000, d=128, nnz=a.nnz,
                                      lanes=plan.total_blocks * 128)
    c = auto_stream_chunks(plan, a.nnz, device_mem_bytes=whole * 0.99)
    assert c is not None and c >= 2


def test_build_graph_auto_on_the_cpu_never_chunks(monkeypatch):
    """Under a budget the plan does not fit, auto_stream_chunks asks for
    window chunks; a CPU graph is built whole all the same, and no question
    goes to the card."""
    a = symmetrize(chung_lu_csr(2000, 10_000, seed=6))
    plan = vt.csr_preprocess(a.indptr, a.indices, 2000, vt.PlanConfig())
    assert auto_stream_chunks(plan, a.nnz, device_mem_bytes=1.0) == 64

    def no_card(*args, **kwargs):
        raise AssertionError("a CPU graph asked the card")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_card)
    monkeypatch.setattr(vt.models.graph, "auto_stream_chunks", no_card)
    monkeypatch.setenv("VOLTRIX_TORCH_DEVICE_MEM_GB", "1e-9")
    g = vt.build_graph(a.indptr, a.indices, 2000, "auto", device="cpu")
    assert isinstance(g.plan, vt.SpmmPlan) and g.plan.config == vt.PlanConfig()


@pytest.mark.parametrize("variant,want", [
    (Variant("pregather"), ["spmm_block"]),
    (Variant("pregather", block_h=1024, block_unroll=4, subtile=True), ["spmm_subtile"]),
    (Variant("fused", block_h=2048, gather_segment=128, block_unroll=4), ["spmm_fused"]),
    (Variant("hybrid", gather_segment=8), ["spmm_fused", "spmm_block"]),
    (Variant("hybrid", block_h=2048, gather_segment=8, subtile=True),
     ["spmm_fused", "spmm_subtile"]),
    (Variant("int8"), ["spmm_int8"]),
    (Variant("ell", block_unroll=4), ["spmm_ell"]),
    (Variant("weighted"), ["spmm_weighted"]),
])
def test_variant_kernels_name_the_counted_wrappers_and_their_builds(variant, want):
    """`Variant.kernels()` names the wrappers whose launch counts move (the
    main launch first, the work list's kernel name) and `_loaders` builds
    those kernels' libraries, one a kernel, in the same order."""
    from voltrix_spmm_tpu_torch import ops

    assert variant.kernels() == want
    assert all(hasattr(getattr(ops, k), "launches") for k in want)
    module = {"spmm_block": "block_spmm", "spmm_subtile": "subtile_spmm",
              "spmm_fused": "fused_spmm", "spmm_int8": "quant", "spmm_ell": "ell",
              "spmm_weighted": "weighted"}
    assert [f.__module__ for f in ttuner._loaders(variant)] == [
        f"voltrix_spmm_tpu_torch.ops.{module[k]}" for k in want]


def test_race_keeps_each_candidates_variant_and_no_cpu_peak(problem, tmp_path):
    """A race keeps each candidate's (ordering, Variant) by key, also through
    a disk hit, so no key is parsed; on the CPU no device peak is taken."""
    a, feat, _ = problem
    space = tiny_space()
    tuned = tune(tmp_path, a, feat, space=space, reorderings=("identity", "rcm"))
    want = {f"{o}|{v.key()}": (o, v) for o in ("identity", "rcm") for v in space}
    assert tuned.variants == want and set(tuned.candidates) == set(want)
    assert tuned.peak_bytes == {} and ttuner.peak_bytes(lambda: None, torch.device("cpu")) is None
    fresh = tune(tmp_path, a, feat, space=space, reorderings=("identity", "rcm"))
    assert fresh is not tuned and fresh.variants == want


def test_both_tuners_share_the_cache_dir_and_budget_defaults(monkeypatch, tmp_path):
    from voltrix_spmm_tpu_torch.tuner import AttentionTuner

    monkeypatch.setenv("VOLTRIX_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("VOLTRIX_TORCH_TUNE_BUDGET_S", "7.5")
    for tuner, prefix in ((SpmmTuner(), "tune"), (AttentionTuner(), "tune_attn")):
        assert tuner.cache_dir() == str(tmp_path)
        assert tuner._disk_path("sig") == os.path.join(str(tmp_path), f"{prefix}.sig.json")
        assert tuner._budget(None) == 7.5 and tuner._budget(3.0) == 3.0
    assert SpmmTuner(cache_dir="elsewhere").cache_dir() == "elsewhere"

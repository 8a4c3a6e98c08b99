"""The port's deployment formats against the JAX package on the CPU: the
native C++/OpenMP plan preprocess (runtime/native.py) against JAX's native
preprocess and the port's numpy path, plan files (`SpmmPlan.save` / `load`)
across the two packages, and `validate_plan` against JAX's. Inputs are
made from numpy seeds; plans are compared bit for bit."""

import dataclasses
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.format.diagnostics import PlanInvariantError as JaxPlanInvariantError
from voltrix_spmm_tpu.format.diagnostics import validate_plan as jax_validate_plan
from voltrix_spmm_tpu.runtime import native_available as jax_native_available
from voltrix_spmm_tpu_torch.format.cluster import packed_stats
from voltrix_spmm_tpu_torch.format.diagnostics import PlanInvariantError, validate_plan
from voltrix_spmm_tpu_torch.runtime import native
from voltrix_spmm_tpu_torch.runtime.native import native_spmm_oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1000


def power_law(n, edges, seed, num_cols=None, empty_every=0):
    """A small CSR with hub rows and columns (Chung-Lu weights), duplicate
    entries summed away; every `empty_every`-th row emptied."""
    rng = np.random.default_rng(seed)
    cols_n = num_cols or n
    w_r = 1.0 / np.arange(1, n + 1) ** 0.8
    w_c = 1.0 / np.arange(1, cols_n + 1) ** 0.8
    rows = rng.choice(n, edges, p=w_r / w_r.sum())
    cols = rng.choice(cols_n, edges, p=w_c / w_c.sum())
    if empty_every:
        keep = rows % empty_every != 0
        rows, cols = rows[keep], cols[keep]
    a = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(n, cols_n))
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


@pytest.fixture(scope="module")
def graph():
    return power_law(N, 12000, seed=0)


def assert_same(tplan, jplan):
    np.testing.assert_array_equal(tplan.bitmask.numpy().view(np.uint32), np.asarray(jplan.bitmask))
    for name in ("hind", "window_of_block", "block_ptr"):
        got = getattr(tplan, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jplan, name)), err_msg=name)
    if jplan.occ is None:
        assert tplan.occ is None
    else:
        np.testing.assert_array_equal(tplan.occ.numpy().view(np.uint32),
                                      np.asarray(jplan.occ).view(np.uint32))
    for name in ("num_nodes", "num_edges", "num_windows", "total_blocks", "has_empty_windows",
                 "num_cols"):
        assert getattr(tplan, name) == getattr(jplan, name), name


def assert_same_port(p, q):
    for name in ("bitmask", "hind", "window_of_block", "block_ptr", "occ", "values"):
        x, y = getattr(p, name), getattr(q, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    assert dataclasses.replace(p, **dict.fromkeys(
        ("bitmask", "hind", "window_of_block", "block_ptr", "occ", "values"))) == \
        dataclasses.replace(q, **dict.fromkeys(
            ("bitmask", "hind", "window_of_block", "block_ptr", "occ", "values")))


# the configs of tests/test_diagnostics_batching.py:13-20, then cluster_cols,
# gather_segment 128, block_unroll 4, rectangular num_cols and empty rows
NATIVE_CASES = [
    ("h32", dict(block_h=32, block_w=128), {}),
    ("seg8", dict(block_h=128, block_w=128, gather_segment=8), {}),
    ("h32_unroll4", dict(block_h=32, block_w=128, block_unroll=4), {}),
    ("h64_w256_seg16", dict(block_h=64, block_w=256, gather_segment=16, block_unroll=2), {}),
    ("clustered", dict(block_h=256, block_w=128, block_unroll=4, cluster_cols=True), {}),
    ("clustered_seg8", dict(block_h=256, block_w=128, gather_segment=8, cluster_cols=True), {}),
    ("seg128", dict(block_h=512, block_w=128, gather_segment=128, block_unroll=4), {}),
    ("rectangular", dict(block_h=128, block_w=128), dict(num_cols=1500)),
    ("empty_rows", dict(block_h=32, block_w=128, block_unroll=2), dict(empty_every=3)),
]


@pytest.mark.parametrize("name,cfg,shape", NATIVE_CASES, ids=[c[0] for c in NATIVE_CASES])
def test_native_plan_matches_jax_native_and_numpy(graph, name, cfg, shape):
    if not jax_native_available():
        pytest.fail("the JAX package's native preprocess does not build here")
    a = graph if not shape else power_law(N, 12000, seed=1, **shape)
    num_cols = shape.get("num_cols")
    tn = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(**cfg), backend="native",
                           num_cols=num_cols)
    tp = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(**cfg), backend="numpy",
                           num_cols=num_cols)
    jn = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(**cfg), backend="native",
                             num_cols=num_cols)
    assert_same(tn, jn)
    assert_same_port(tn, tp)
    validate_plan(tn)


def test_auto_backend_is_native_and_disable_flag(graph, monkeypatch):
    cfg = vt.PlanConfig(block_h=64)
    auto = vt.csr_preprocess(graph.indptr, graph.indices, N, cfg)
    assert_same_port(auto, vt.csr_preprocess(graph.indptr, graph.indices, N, cfg, backend="native"))
    monkeypatch.setenv("VOLTRIX_TORCH_DISABLE_NATIVE", "1")
    assert not native.native_available()
    assert_same_port(vt.csr_preprocess(graph.indptr, graph.indices, N, cfg), auto)
    with pytest.raises(ValueError, match="unknown backend"):
        vt.csr_preprocess(graph.indptr, graph.indices, N, cfg, backend="jax")


def test_native_asked_outright_raises_when_the_build_fails(graph, monkeypatch, caplog):
    native._build.cache_clear()
    monkeypatch.setenv("VOLTRIX_TORCH_CXX", os.path.join(ROOT, "no-such-compiler"))
    try:
        with pytest.raises(RuntimeError, match="no-such-compiler"):
            vt.csr_preprocess(graph.indptr, graph.indices, N, vt.PlanConfig(), backend="native")
        with caplog.at_level(logging.WARNING, logger="voltrix_torch"):
            assert not native.native_available()
        assert "native preprocessing unavailable" in caplog.text
        # "auto" takes the numpy path, with the same plan
        monkeypatch.delenv("VOLTRIX_TORCH_CXX")
        numpy_plan = vt.csr_preprocess(graph.indptr, graph.indices, N, vt.PlanConfig(),
                                       backend="numpy")
    finally:
        native._build.cache_clear()
    assert_same_port(vt.csr_preprocess(graph.indptr, graph.indices, N, vt.PlanConfig(),
                                       backend="native"), numpy_plan)


def test_native_int32_range_takes_numpy_with_a_warning(graph, caplog):
    span = 2**31 + 5  # a column space past int32: the JAX package's rule
    with caplog.at_level(logging.WARNING, logger="voltrix_torch"):
        plan = vt.csr_preprocess(graph.indptr, graph.indices, N, vt.PlanConfig(),
                                 backend="native", num_cols=span)
    assert "exceeds int32 range" in caplog.text
    assert_same_port(plan, vt.csr_preprocess(graph.indptr, graph.indices, N, vt.PlanConfig(),
                                             backend="numpy", num_cols=span))


def test_native_thread_count_changes_no_bit(graph, tmp_path):
    cfg = dict(block_h=256, block_w=128, block_unroll=4, cluster_cols=True)
    np.savez(tmp_path / "g.npz", indptr=graph.indptr, indices=graph.indices)
    code = ("import numpy as np, voltrix_spmm_tpu_torch as vt; "
            f"z = np.load({str(tmp_path / 'g.npz')!r}); "
            f"p = vt.csr_preprocess(z['indptr'], z['indices'], {N}, vt.PlanConfig(**{cfg!r}), "
            "backend='native'); "
            f"p.save({str(tmp_path / 'one_thread.npz')!r})")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "OMP_NUM_THREADS": "1"})
    many = vt.csr_preprocess(graph.indptr, graph.indices, N, vt.PlanConfig(**cfg),
                             backend="native")
    assert_same_port(vt.SpmmPlan.load(str(tmp_path / "one_thread.npz")), many)


def test_native_spmm_oracle(graph):
    x = np.random.default_rng(2).standard_normal((N, 24)).astype(np.float32)
    got = native_spmm_oracle(graph.indptr, graph.indices, N, x)
    np.testing.assert_allclose(got, graph @ x.astype(np.float64), rtol=1e-5, atol=1e-4)


# plan files: (config, build kwargs) of the plans written by one package and
# read by the other
FILE_CASES = [
    ("h128", dict(block_h=128, block_w=128), {}),
    ("clustered_occ", dict(block_h=256, block_w=128, block_unroll=4, cluster_cols=True), {}),
    ("weighted", dict(block_h=128, block_w=128), dict(values=True)),
    ("rectangular", dict(block_h=128, block_w=128), dict(num_cols=1500)),
    ("h32_dense_only", dict(block_h=32, block_w=128), {}),
]


def file_plans(graph, cfg, kw):
    a = power_law(N, 12000, seed=1, num_cols=kw["num_cols"]) if "num_cols" in kw else graph
    values = None
    if kw.get("values"):
        values = np.random.default_rng(3).standard_normal(a.nnz).astype(np.float32)
    args = (a.indptr, a.indices, N)
    jplan = jfmt.csr_preprocess(*args, jfmt.PlanConfig(**cfg), backend="numpy",
                                num_cols=kw.get("num_cols"), values=values)
    tplan = vt.csr_preprocess(*args, vt.PlanConfig(**cfg), num_cols=kw.get("num_cols"),
                              values=values)
    return jplan, tplan


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("name,cfg,kw", FILE_CASES, ids=[c[0] for c in FILE_CASES])
def test_plan_files_cross_packages(graph, tmp_path, name, cfg, kw, packed):
    jplan, tplan = file_plans(graph, cfg, kw)
    # JAX writes, the port reads
    path = jplan.save(str(tmp_path / "jax_plan"), packed=packed)
    loaded = vt.SpmmPlan.load(path)
    assert_same(loaded, jplan)
    assert_same_port(loaded, tplan)
    # the port writes, JAX reads; the port reads its own file back
    path = tplan.save(str(tmp_path / "port_plan.npz"), packed=packed)
    with np.load(path) as z:
        assert ("bitmask_packed" in z) == (packed and cfg["block_h"] % 128 == 0)
        assert z["bitmask" if "bitmask" in z else "bitmask_packed"].dtype == np.uint32
    back = jfmt.SpmmPlan.load(path)
    assert_same(tplan, back)
    for name_ in ("values", "src_perm"):
        got = getattr(back, name_)
        want = getattr(jplan, name_)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    assert_same_port(vt.SpmmPlan.load(path), tplan)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_packed_stats_match_jax(graph):
    from voltrix_spmm_tpu.format.cluster import packed_stats as jax_packed_stats

    cfg = dict(block_h=256, block_w=128, block_unroll=4, cluster_cols=True)
    jplan, tplan = file_plans(graph, cfg, {})
    got, want = packed_stats(tplan.bitmask), jax_packed_stats(np.asarray(jplan.bitmask))
    assert got == want and 0.0 < got["saving"] < 1.0


VALID_CONFIGS = [
    dict(block_h=32, block_w=128),
    dict(block_h=128, block_w=128, gather_segment=8),
    dict(block_h=32, block_w=128, block_unroll=4),
    dict(block_h=64, block_w=256, gather_segment=16, block_unroll=2),
]


@pytest.mark.parametrize("cfg", VALID_CONFIGS, ids=["h32", "seg8", "unroll4", "h64_w256_seg16"])
def test_validate_plan_passes_as_jax(cfg):
    a = sp.random(500, 500, density=0.03, format="csr", random_state=np.random.default_rng(0))
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, 500, jfmt.PlanConfig(**cfg), backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, 500, vt.PlanConfig(**cfg))
    jax_validate_plan(jplan)
    validate_plan(tplan)
    assert issubclass(PlanInvariantError, AssertionError)


def corruptions(plan, module):
    """tests/test_diagnostics_batching.py:33's corruptions, then more of the
    named checks: (name, corrupted plan) pairs."""
    t = module is torch

    def copy(x):
        return x.clone() if t else np.asarray(x).copy()

    hind = copy(plan.hind)
    hind[0, 0] = 10**6
    wob = copy(plan.window_of_block)
    wob[0] = wob[-1]
    bp = copy(plan.block_ptr)
    bp[-1] += 1
    bm = copy(plan.bitmask)
    bm[-1, -1, :] = -1 if t else np.uint32(0xFFFFFFFF)  # bits on the padded tail rows
    neg = copy(plan.hind)
    neg[1, 2] = -3
    return [
        ("hind within", dataclasses.replace(plan, hind=hind)),
        ("window_of_block", dataclasses.replace(plan, window_of_block=wob)),
        ("block_ptr total", dataclasses.replace(plan, block_ptr=bp)),
        ("padded tail rows empty", dataclasses.replace(plan, bitmask=bm)),
        ("hind non-negative", dataclasses.replace(plan, hind=neg)),
        ("has_empty_windows flag", dataclasses.replace(
            plan, has_empty_windows=not plan.has_empty_windows)),
    ]


def test_validate_plan_names_the_violations_jax_names():
    a = sp.random(300, 300, density=0.03, format="csr", random_state=np.random.default_rng(0))
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, 300, jfmt.PlanConfig(32, 128),
                                backend="numpy")
    tplan = vt.csr_preprocess(a.indptr, a.indices, 300, vt.PlanConfig(32, 128))
    for (name, jbad), (_, tbad) in zip(corruptions(jplan, np), corruptions(tplan, torch)):
        with pytest.raises(JaxPlanInvariantError) as jerr:
            jax_validate_plan(jbad)
        with pytest.raises(PlanInvariantError) as terr:
            validate_plan(tbad)
        assert name in str(terr.value)
        assert str(terr.value) == str(jerr.value)


def test_validate_plan_checks_survive_python_O():
    """Every check raises through an explicit `if`: the module holds no
    `assert`, which `python -O` would strip."""
    import ast
    import inspect

    from voltrix_spmm_tpu_torch.format import diagnostics

    tree = ast.parse(inspect.getsource(diagnostics))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Assert)]

"""Parity of the port's parallel/ (torch.distributed) with the JAX
package's on the CPU: the build_* plans bit for bit, each mode's SpMM and its
gradient on gloo CPU ranks against the JAX function on the conftest's
virtual devices, the launcher's failures, and the refusals of the checks
the JAX package makes with `assert`.

Ranks are spawned once per group of cases (`comm.launch` of a worker of
`voltrix_spmm_tpu_torch.parallel.checks`); the JAX side runs jitted, its
Pallas kernels in interpret mode. Tolerances are the JAX tests' own for
the same comparison: forward rtol 1e-5, atol 1e-4 (tests/test_parallel.py
:71, tests/test_grid2d.py:51), the ring's and hybrid's gradient rtol
1e-4, atol 1e-3 (tests/test_parallel.py:249, :520), the grid's rtol 1e-4,
atol 1e-4 (tests/test_grid2d.py:83), dp x tp's SpMM rtol 1e-5, atol 1e-4
and logits rtol 1e-4, atol 1e-3 (tests/test_parallel.py:40, :53).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu.parallel as jpar
import voltrix_spmm_tpu_torch.parallel as tpar
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.parallel.row_sharded_gcn import _local_aggregate as jax_local_aggregate
from voltrix_spmm_tpu_torch import PlanConfig
from voltrix_spmm_tpu_torch.parallel import checks, comm

CFG, JCFG = PlanConfig(32, 128), JaxPlanConfig(32, 128)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-5, atol=1e-4)


def graph(n=300, density=0.04, seed=1, symmetric=False, hubs=0):
    """A random binary CSR; `hubs` dense rows make the degrees skewed."""
    rng = np.random.default_rng(seed)
    dense = rng.random((n, n)) < density
    if hubs:
        dense[:hubs] = rng.random((hubs, n)) < 0.4
    if symmetric:
        dense = dense | dense.T
    return sp.csr_matrix(dense.astype(np.float32))


def mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


# --- the package's surface ---------------------------------------------------

def test_exports_match_the_jax_package():
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert all(hasattr(tpar, name) for name in tpar.__all__)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_and_chip_smoke_import_no_jax():
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "voltrix_spmm_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = [(os.path.relpath(p, ROOT), m) for p in sources for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "voltrix_spmm_tpu")]
    assert len(sources) > 60 and not bad


# --- the build_* plans, bit for bit ------------------------------------------

GRAPHS = {"uniform 300": lambda: graph(), "hubs 200": lambda: graph(200, 0.02, 2, hubs=15),
          "symmetric 257": lambda: graph(257, 0.05, 3, symmetric=True)}
FIELDS = ("bitmask", "hind", "window_of_block", "block_ptr")


def same_arrays(ours, theirs, transpose=True):
    for f in FIELDS + (tuple(f + "_t" for f in FIELDS) if transpose else ()):
        a, b = getattr(ours, f), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("balance", [False, True])
def test_row_sharded_plan_matches_jax(name, ndev, balance):
    a = GRAPHS[name]()
    n = a.shape[0]
    ours = tpar.build_row_sharded_plan(a.indptr, a.indices, n, ndev, CFG, with_transpose=True,
                                       balance=balance)
    theirs = jpar.build_row_sharded_plan(a.indptr, a.indices, n, ndev, JCFG,
                                         with_transpose=True, balance=balance)
    same_arrays(ours, theirs)
    for f in ("num_nodes", "shard_rows", "tb_max", "ndev", "tbt_max"):
        assert getattr(ours, f) == getattr(theirs, f), f
    if balance:
        assert np.array_equal(ours.row_perm, theirs.row_perm)
    else:
        assert ours.row_perm is None and theirs.row_perm is None
    assert ours.num_nodes % (ndev * 32) == 0 and ours.num_nodes >= n


def test_row_sharded_plan_without_transpose_matches_jax():
    a = GRAPHS["hubs 200"]()
    ours = tpar.build_row_sharded_plan(a.indptr, a.indices, 200, 4, CFG)
    theirs = jpar.build_row_sharded_plan(a.indptr, a.indices, 200, 4, JCFG)
    same_arrays(ours, theirs, transpose=False)
    assert ours.bitmask_t is None and ours.tbt_max == 0


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_ring_plan_matches_jax(name, ndev):
    a = GRAPHS[name]()
    n = a.shape[0]
    ours = tpar.build_ring_sharded_plan(a.indptr, a.indices, n, ndev, CFG, with_transpose=True)
    theirs = jpar.build_ring_sharded_plan(a.indptr, a.indices, n, ndev, JCFG,
                                          with_transpose=True)
    same_arrays(ours, theirs)
    for f in ("num_nodes", "shard_rows", "tb_max", "ndev", "tbt_max"):
        assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (4, 2)])
def test_grid2d_plan_matches_jax(name, shape):
    a = GRAPHS[name]()
    n = a.shape[0]
    ours = tpar.build_grid2d_plan(a.indptr, a.indices, n, *shape, CFG, with_transpose=True)
    theirs = jpar.build_grid2d_plan(a.indptr, a.indices, n, *shape, JCFG, with_transpose=True)
    same_arrays(ours, theirs)
    for f in ("num_nodes", "shard", "tb_max", "nrow", "ncol", "tbt_max"):
        assert getattr(ours, f) == getattr(theirs, f), f


# --- the launcher ------------------------------------------------------------

def test_launch_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed(.|\n)*fails on purpose"):
        comm.launch(checks.fail_on_rank, 2, 1, device="cpu", timeout=60)


def test_launch_stops_a_rank_that_hangs_within_its_timeout():
    import time

    t0 = time.monotonic()
    # rank 1 returns at once, but may still be starting when the time is up
    with pytest.raises(TimeoutError, match=r"ranks \[0(, 1)?\] of 2 did not finish within 6"):
        comm.launch(checks.sleep_on_rank, 2, 0, 600.0, device="cpu", timeout=6.0)
    assert time.monotonic() - t0 < 6.0 + 15.0  # the timeout, then terminate and join


def test_launch_refuses_nccl_on_cpu_tensors():
    with pytest.raises(ValueError, match="does not take device"):
        comm.launch(checks.sleep_on_rank, 1, 0, 0.0, backend="nccl", device="cpu")


@pytest.mark.parametrize("world, device, cards, want", [
    (4, "cpu", 0, "gloo"), (4, "cpu", 4, "gloo"), (1, "cuda", 1, "nccl"),
    (2, "cuda", 1, "gloo"), (4, "cuda", 4, "nccl"), (8, "cuda", 4, "gloo")])
def test_default_backend(monkeypatch, world, device, cards, want):
    """NCCL when every rank has a card of its own, else gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert comm.default_backend(world, device) == want


def test_launch_takes_the_card_by_default(monkeypatch):
    """Without device="cpu" the ranks go to the card: with none, the
    launcher refuses before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device is available; pass device='cpu'"):
        comm.launch(checks.sleep_on_rank, 1, 0, 0.0)


def test_launch_refuses_nccl_on_a_shared_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl takes one rank a card: 2 ranks, 1 cards"):
        comm.launch(checks.sleep_on_rank, 2, 0, 0.0, backend="nccl")


# --- refusals: the JAX package's asserts, as ValueErrors ---------------------

def _refusal_cases():
    a = graph(100, 0.05, 4)
    fwd_row = tpar.build_row_sharded_plan(a.indptr, a.indices, 100, 1, CFG)
    fwd_ring1 = tpar.build_ring_sharded_plan(a.indptr, a.indices, 100, 1, CFG)
    ring2 = tpar.build_ring_sharded_plan(a.indptr, a.indices, 100, 2, CFG, with_transpose=True)
    fwd_grid = tpar.build_grid2d_plan(a.indptr, a.indices, 100, 1, 1, CFG)
    grid12 = tpar.build_grid2d_plan(a.indptr, a.indices, 100, 1, 2, CFG, with_transpose=True)
    s = fwd_row.shard_rows
    return {
        # name: (case, the message), by the JAX file:line of the assert
        "sharded.py:38 dp x tp": ({"call": "make_mesh"}, r"dp 2 x tp 1 != 1 ranks"),
        "row_sharded.py:280 rows": ({"call": "row_sharded_spmm", "plan": fwd_row, "rows": s + 1},
                                    r"row_sharded_spmm: x must be this rank's \(128, D\)"),
        "row_sharded_gcn.py:149 transpose": ({"call": "make_row_sharded_train_step",
                                              "plan": fwd_row}, r"with_transpose=True"),
        "ring.py:256 rows": ({"call": "ring_sharded_spmm", "plan": fwd_ring1, "rows": s - 32},
                             r"ring_sharded_spmm: x must be"),
        "ring.py:310 transpose": ({"call": "make_ring_train_step", "plan": fwd_ring1},
                                  r"with_transpose=True\) required for training"),
        "hybrid.py:122 rows": ({"call": "hybrid_sharded_spmm", "plan": fwd_ring1, "rows": 0},
                               r"hybrid_sharded_spmm: x must be"),
        "hybrid.py:125 mesh": ({"call": "hybrid_sharded_spmm", "plan": ring2,
                                "rows": ring2.shard_rows},
                               r"a 1 x 1 mesh does not hold the plan's 2 shards"),
        "hybrid.py:181 transpose": ({"call": "make_hybrid_train_step", "plan": fwd_ring1},
                                    r"with_transpose=True\) required for training"),
        "grid2d.py:281 rows": ({"call": "grid2d_spmm", "plan": fwd_grid, "rows": 1},
                               r"grid2d_spmm: x must be"),
        "grid2d.py:283 mesh": ({"call": "grid2d_spmm", "plan": grid12, "rows": grid12.shard},
                               r"the mesh is 1 x 1, the plan 1 x 2"),
        "grid2d.py:342 transpose": ({"call": "make_grid2d_train_step", "plan": fwd_grid},
                                    r"with_transpose=True\) required for training"),
        # the port's own: a mesh over a part of the world, a tuple axis out
        # of the mesh's order (its ranks would not number row-major)
        "make_mesh size": ({"call": "make_mesh_size"}, r"n_devices 2 != world size 1"),
        "axis out of order": ({"call": "axis_order"},
                              r"must name dimensions of the mesh \['host', 'chip'\] in its"),
        # the backward of a plan built without its transposes
        "ring backward": ({"call": "ring_backward", "plan": fwd_ring1, "rows": s},
                          r"with_transpose=True\) required for the backward ring"),
        "hybrid backward": ({"call": "hybrid_backward", "plan": fwd_ring1, "rows": s},
                            r"with_transpose=True\) required for the hybrid backward"),
        "grid2d backward": ({"call": "grid2d_backward", "plan": fwd_grid, "rows": s},
                            r"with_transpose=True\) required for the grid2d backward"),
    }


REFUSALS = _refusal_cases()


@pytest.fixture(scope="module")
def refusals():
    """Every refusal case on one gloo CPU rank."""
    (out,) = comm.launch(checks.refusal_cases, 1, {k: c for k, (c, _) in REFUSALS.items()},
                         "cpu", device="cpu", timeout=120)
    return out


@pytest.mark.parametrize("name", REFUSALS)
def test_refusal_raises_value_error(refusals, name):
    msg = refusals[name]
    assert msg is not None, f"{name} did not raise"
    import re

    assert re.search(REFUSALS[name][1], msg), msg


# --- each mode's SpMM and its gradient against the JAX function --------------

def _spmm_problem():
    a = graph()
    n, d = a.shape[0], 16
    rng = np.random.default_rng(5)
    cases = {}
    for balance in (False, True):
        cases[f"row_sharded balance={balance}"] = {
            "mode": "row_sharded", "plan": tpar.build_row_sharded_plan(
                a.indptr, a.indices, n, 4, CFG, with_transpose=True, balance=balance)}
    ring = tpar.build_ring_sharded_plan(a.indptr, a.indices, n, 4, CFG, with_transpose=True)
    cases["ring 4"] = {"mode": "ring", "plan": ring}
    cases["hybrid 2x2"] = {"mode": "hybrid", "plan": ring, "mesh": (2, 2)}
    for shape in ((2, 2), (1, 4)):
        cases[f"grid2d {shape[0]}x{shape[1]}"] = {
            "mode": "grid2d", "mesh": shape, "plan": tpar.build_grid2d_plan(
                a.indptr, a.indices, n, *shape, CFG, with_transpose=True)}
    for c in cases.values():
        n_pad = c["plan"].num_nodes
        c["x"] = np.zeros((n_pad, d), np.float32)
        c["x"][:n] = rng.standard_normal((n, d))
        c["w"] = rng.standard_normal((n_pad, d)).astype(np.float32)
    s = graph(192, 0.05, 6, symmetric=True)
    params = {k: np.asarray(v) for k, v in
              jmodels.init_gcn(jax.random.PRNGKey(0), 32, 64, 4).items()}
    params["b1"] = rng.standard_normal(64).astype(np.float32) * 0.1
    cases["dp_tp 2x2"] = {
        "mode": "dp_tp", "mesh": (2, 2), "indptr": s.indptr, "indices": s.indices, "n": 192,
        "cfg": CFG, "feat": rng.standard_normal((192, 64)).astype(np.float32),
        "params": params, "x": rng.standard_normal((2, 192, 32)).astype(np.float32),
        "w": rng.standard_normal((2, 192, 4)).astype(np.float32), "a": s}
    return a, cases


A_SPMM, SPMM_CASES = _spmm_problem()


@pytest.fixture(scope="module")
def spmm_results():
    """Every SpMM case on 4 gloo CPU ranks, in one launch: per case, the
    port's (out, grad) assembled in the original row order."""
    sent = {k: {f: v for f, v in c.items() if f != "a"} for k, c in SPMM_CASES.items()}
    ranks = comm.launch(checks.spmm_cases, 4, sent, "cpu", device="cpu", timeout=180)
    out = {}
    for name, case in SPMM_CASES.items():
        if case["mode"] == "dp_tp":
            out[name] = [r[name] for r in ranks]
            continue
        by = {r[name]["index"]: r[name] for r in ranks}
        assert sorted(by) == [0, 1, 2, 3]
        plan = case["plan"]
        out[name] = tuple(plan.assemble([by[i][k] for i in range(4)]) for k in ("out", "grad"))
    return out


def _jax_plan(case):
    a, n = A_SPMM, A_SPMM.shape[0]
    mode, shape = case["mode"], case.get("mesh")
    if mode == "row_sharded":
        return jpar.build_row_sharded_plan(a.indptr, a.indices, n, 4, JCFG, with_transpose=True,
                                           balance=case["plan"].row_perm is not None)
    if mode == "grid2d":
        return jpar.build_grid2d_plan(a.indptr, a.indices, n, *shape, JCFG, with_transpose=True)
    return jpar.build_ring_sharded_plan(a.indptr, a.indices, n, 4, JCFG, with_transpose=True)


def _jax_row_sharded_grad(plan, x, w):
    """The gradient of sum(A @ x * w) through the JAX trainer's
    `_local_aggregate` (all-gather, spmm_ad over the shard's transpose
    plan) under shard_map, scattered back to the original row order."""
    m = mesh((4,), ("data",))
    perm = plan.row_perm

    def local(bm, hi, wob, bp, bmt, hit, wobt, bpt, xl, wl):
        shard = (bm[0], hi[0], wob[0], bp[0], bmt[0], hit[0], wobt[0], bpt[0])
        return jax.grad(lambda v: jnp.sum(jax_local_aggregate(plan, shard, v, "data") * wl[0]))(
            xl[0])[None]

    f = jax.jit(shard_map(local, mesh=m, in_specs=(P("data"),) * 10, out_specs=P("data"),
                          check_vma=False))
    xs, ws = (x, w) if perm is None else (x[perm], w[perm])
    arrs = [np.asarray(getattr(plan, k)) for k in (
        "bitmask", "hind", "window_of_block", "block_ptr", "bitmask_t", "hind_t",
        "window_of_block_t", "block_ptr_t")]
    g = np.asarray(f(*arrs, xs.reshape(4, plan.shard_rows, -1),
                     ws.reshape(4, plan.shard_rows, -1))).reshape(plan.num_nodes, -1)
    if perm is None:
        return g
    out = np.zeros_like(g)
    out[perm] = g
    return out


def _jax_spmm(case):
    """(A @ x, the gradient of sum(A @ x * w) in x) by the JAX function."""
    jplan, x, w = _jax_plan(case), jnp.asarray(case["x"]), jnp.asarray(case["w"])
    mode = case["mode"]
    if mode == "row_sharded":
        out = jax.jit(lambda v: jpar.row_sharded_spmm(jplan, v, mesh((4,), ("data",))))(x)
        return np.asarray(out), _jax_row_sharded_grad(jplan, case["x"], case["w"])
    if mode == "ring":
        fn = lambda v: jpar.ring_sharded_spmm(jplan, v, mesh((4,), ("data",)))  # noqa: E731
    elif mode == "hybrid":
        fn = lambda v: jpar.hybrid_sharded_spmm(jplan, v, mesh((2, 2), ("host", "chip")))  # noqa
    else:
        fn = lambda v: jpar.grid2d_spmm(jplan, v, mesh(case["mesh"], ("row", "col")))  # noqa
    out, grad = jax.jit(lambda v: (fn(v), jax.grad(lambda u: jnp.sum(fn(u) * w))(v)))(x)
    return np.asarray(out), np.asarray(grad)


GRAD_TOL = {"row_sharded": dict(rtol=1e-4, atol=1e-3), "ring": dict(rtol=1e-4, atol=1e-3),
            "hybrid": dict(rtol=1e-4, atol=1e-3), "grid2d": dict(rtol=1e-4, atol=1e-4)}
ROW_CASES = [k for k, c in SPMM_CASES.items() if c["mode"] != "dp_tp"]


@pytest.fixture(scope="module")
def jax_spmm():
    return {}


def _jax_result(cache, name):
    if name not in cache:
        cache[name] = _jax_spmm(SPMM_CASES[name])
    return cache[name]


@pytest.mark.parametrize("name", ROW_CASES)
def test_spmm_matches_jax(spmm_results, jax_spmm, name):
    out, _ = spmm_results[name]
    want, _ = _jax_result(jax_spmm, name)
    np.testing.assert_allclose(out, want, **FWD)
    n = A_SPMM.shape[0]
    assert np.abs(out[n:]).max() == 0.0  # padding rows stay zero


@pytest.mark.parametrize("name", ROW_CASES)
def test_spmm_gradient_matches_jax(spmm_results, jax_spmm, name):
    _, grad = spmm_results[name]
    _, want = _jax_result(jax_spmm, name)
    np.testing.assert_allclose(grad, want, **GRAD_TOL[SPMM_CASES[name]["mode"]])


def _dp_tp_jax(case):
    a = case["a"]
    g = jmodels.build_graph(a.indptr, a.indices, case["n"], JCFG)
    m = mesh((2, 2), ("data", "model"))
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    x, w = jnp.asarray(case["x"]), jnp.asarray(case["w"])
    spmm = jax.jit(lambda v: jpar.sharded_spmm(g.plan, v, m))(jnp.asarray(case["feat"]))
    logits = jax.jit(lambda p: jpar.sharded_gcn_forward(p, g, x, m))(params)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jmodels.gcn_forward(p, g, x) * w)))(params)
    return np.asarray(spmm), np.asarray(logits), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def dp_tp_jax():
    return _dp_tp_jax(SPMM_CASES["dp_tp 2x2"])


def _by_coords(ranks):
    return {r["coords"]: r for r in ranks}


def test_dp_tp_sharded_spmm_matches_jax(spmm_results, dp_tp_jax):
    by = _by_coords(spmm_results["dp_tp 2x2"])
    for i in range(2):  # each data row holds the whole product, split over "model"
        got = np.concatenate([by[(i, j)]["spmm"] for j in range(2)], axis=1)
        np.testing.assert_allclose(got, dp_tp_jax[0], **FWD)


def test_dp_tp_gcn_forward_matches_jax(spmm_results, dp_tp_jax):
    by = _by_coords(spmm_results["dp_tp 2x2"])
    for j in range(2):  # every model rank holds the summed logits of its graphs
        got = np.concatenate([by[(i, j)]["logits"] for i in range(2)])
        np.testing.assert_allclose(got, dp_tp_jax[1], rtol=1e-4, atol=1e-3)


def test_dp_tp_gradients_match_jax(spmm_results, dp_tp_jax):
    """Each rank's parameter slices' gradients, summed over "data", are
    the slices of the single-device gradient: a row-parallel sum whose
    backward summed again would scale W1's, b1's and W2's by tp."""
    by = _by_coords(spmm_results["dp_tp 2x2"])
    summed = [{k: sum(by[(i, j)]["grads"][k] for i in range(2)) for k in ("w1", "b1", "w2", "b2")}
              for j in range(2)]
    got = tpar.sharded.full_gcn_params(summed)
    for k, want in dp_tp_jax[2].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(summed[0]["b2"], summed[1]["b2"])

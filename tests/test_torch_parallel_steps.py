"""One SGD step of every parallel trainer of the port on gloo CPU ranks
against the JAX package's trainer on the conftest's virtual devices, and
the port's `dryrun_multichip` at world size 4.

The full-graph steps (row-sharded contiguous and balanced, ring, hybrid
2 x 2, the 2D grid 2 x 2 and 1 x 4, and row-sharded over the ("host",
"chip") tuple axis) must give JAX's updated parameters within 1e-5
(tests/test_parallel.py:463) and its loss within rel 1e-5
(tests/test_parallel.py:303, :556); dp x tp 2 x 2 likewise. A gradient
scaled by the axis size (a count summed inside the differentiated
function, or a row-parallel sum whose backward sums) moves an update by far
more than 1e-5. All cases run in one launch of 4 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu.parallel as jpar
import voltrix_spmm_tpu_torch.parallel as tpar
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch import PlanConfig
from voltrix_spmm_tpu_torch.parallel import checks, comm
from voltrix_spmm_tpu_torch.parallel.dryrun import dryrun_multichip

CFG, JCFG = PlanConfig(32, 128), JaxPlanConfig(32, 128)
N, D, HIDDEN, CLASSES, LR = 300, 16, 8, 4, 5e-2
UPDATE_TOL, LOSS_RTOL = 1e-5, 1e-5


def _graph():
    rng = np.random.default_rng(11)
    dense = rng.random((N, N)) < 0.03
    dense[:12] = rng.random((12, N)) < 0.3  # hubs, so balance=True permutes
    return sp.csr_matrix((dense | dense.T).astype(np.float32))


A = _graph()
PARAMS = {k: np.asarray(v) for k, v in jmodels.init_gcn(jax.random.PRNGKey(0), D, HIDDEN,
                                                        CLASSES).items()}
PARAMS["b1"] = np.random.default_rng(12).standard_normal(HIDDEN).astype(np.float32) * 0.1


def _cases():
    ip, ix = A.indptr, A.indices
    ring = tpar.build_ring_sharded_plan(ip, ix, N, 4, CFG, with_transpose=True)
    rows = {b: tpar.build_row_sharded_plan(ip, ix, N, 4, CFG, with_transpose=True, balance=b)
            for b in (False, True)}
    return [
        {"name": "row_sharded contiguous", "mode": "row_sharded", "plan": rows[False]},
        {"name": "row_sharded balanced", "mode": "row_sharded", "plan": rows[True]},
        {"name": "row_sharded (host, chip)", "mode": "row_sharded_2d", "plan": rows[False],
         "mesh": (2, 2)},
        {"name": "ring 4", "mode": "ring", "plan": ring},
        {"name": "hybrid 2x2", "mode": "hybrid", "plan": ring, "mesh": (2, 2)},
        {"name": "grid2d 2x2", "mode": "grid2d", "mesh": (2, 2),
         "plan": tpar.build_grid2d_plan(ip, ix, N, 2, 2, CFG, with_transpose=True)},
        {"name": "grid2d 1x4", "mode": "grid2d", "mesh": (1, 4),
         "plan": tpar.build_grid2d_plan(ip, ix, N, 1, 4, CFG, with_transpose=True)},
        {"name": "dp_tp 2x2", "mode": "dp_tp", "mesh": (2, 2)},
    ]


CASES = _cases()
SPEC = {"indptr": A.indptr, "indices": A.indices, "n": N, "cfg": CFG, "params": PARAMS, "d": D,
        "classes": CLASSES, "seed": 13, "batch": 2, "lr": LR, "steps": 1}
N_PAD = CASES[0]["plan"].num_nodes
ARRAYS = checks.problem_arrays(A.indptr, N, N_PAD, D, CLASSES, 13, batch=2)


@pytest.fixture(scope="module")
def port_steps():
    """Every case's step on 4 gloo CPU ranks, in one launch."""
    return comm.launch(checks.train_cases, 4, dict(SPEC, cases=CASES), "cpu", device="cpu",
                       timeout=180)


def _mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


@pytest.fixture(scope="module")
def jax_steps():
    return {}


def _jax_step(cache, case):
    """(new parameters, loss) of the JAX trainer of the case's mode."""
    if case["name"] not in cache:
        cache[case["name"]] = _run_jax_step(case)
    return cache[case["name"]]


def _run_jax_step(case):
    ip, ix = A.indptr, A.indices
    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    mode = case["mode"]
    if mode == "dp_tp":
        g = jmodels.build_graph(ip, ix, N, JCFG, symmetric=True)
        step = jpar.make_sharded_train_step(_mesh((2, 2), ("data", "model")), lr=LR)
        new, loss = step(params, g, jnp.asarray(ARRAYS["xb"]), jnp.asarray(ARRAYS["yb"]))
    else:
        x, y = jnp.asarray(ARRAYS["x"]), jnp.asarray(ARRAYS["y"].astype(np.int32))
        if mode in ("row_sharded", "row_sharded_2d"):
            plan = jpar.build_row_sharded_plan(ip, ix, N, 4, JCFG, with_transpose=True,
                                               balance=case["plan"].row_perm is not None)
            step = jpar.make_row_sharded_train_step(plan, _mesh((4,), ("data",)),
                                                    ARRAYS["inv_deg"], lr=LR)
        elif mode in ("ring", "hybrid"):
            plan = jpar.build_ring_sharded_plan(ip, ix, N, 4, JCFG, with_transpose=True)
            if mode == "ring":
                step = jpar.make_ring_train_step(plan, _mesh((4,), ("data",)), ARRAYS["inv_deg"],
                                                 lr=LR)
            else:
                step = jpar.make_hybrid_train_step(plan, _mesh((2, 2), ("host", "chip")),
                                                   ARRAYS["inv_deg"], lr=LR)
        else:
            plan = jpar.build_grid2d_plan(ip, ix, N, *case["mesh"], JCFG, with_transpose=True)
            step = jpar.make_grid2d_train_step(plan, _mesh(case["mesh"], ("row", "col")),
                                               ARRAYS["inv_deg"], lr=LR)
        new, loss = step(params, x, y)
    return {k: np.asarray(v) for k, v in new.items()}, float(loss)


def _port_result(ranks, case):
    """(new parameters, loss) assembled from the ranks; every rank of a
    full-graph mode must hold the same parameters and loss."""
    res = [r[case["name"]] for r in ranks]
    # K1's plain version on CPU tensors: 2 forwards and layer 2's backward,
    # a block SpMM each per shard on the ring and hybrid
    calls = 3 * (4 if case["mode"] in ("ring", "hybrid") else 1)
    assert all(r["launches"] == 0 and r["plain_calls"] == calls for r in res)
    if case["mode"] == "dp_tp":
        by = {r["coords"]: r for r in res}
        rows = [tpar.sharded.full_gcn_params([by[(i, j)]["params"] for j in range(2)])
                for i in range(2)]
        for k in rows[0]:
            np.testing.assert_array_equal(rows[0][k], rows[1][k])
        return rows[0], res[0]["losses"][0]
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, res[0]["params"][k])
    assert sorted(r["index"] for r in res) == [0, 1, 2, 3]
    return res[0]["params"], res[0]["losses"][0]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_train_step_matches_jax(port_steps, jax_steps, case):
    got, loss = _port_result(port_steps, case)
    want, want_loss = _jax_step(jax_steps, case)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() < UPDATE_TOL, (k, np.abs(got[k] - v).max())


def test_dp_tp_w1_update_is_not_scaled_by_tp(port_steps, jax_steps):
    """W1's update against JAX's within 1e-5, and against the one a
    row-parallel sum that differentiates into another sum gives (tp = 2 x
    the gradient): the step must be the first, and the two lie far more
    than 1e-5 apart."""
    case = next(c for c in CASES if c["mode"] == "dp_tp")
    got, _ = _port_result(port_steps, case)
    want, _ = _jax_step(jax_steps, case)
    step = want["w1"] - PARAMS["w1"]
    assert np.abs(got["w1"] - want["w1"]).max() < UPDATE_TOL
    assert np.abs(got["w1"] - (PARAMS["w1"] + 2 * step)).max() > 10 * UPDATE_TOL


def test_ranks_come_back_in_rank_order(port_steps):
    """launch returns the ranks' results in rank order: on a contiguous
    plan over the flat mesh, rank r holds shard r."""
    assert [r["row_sharded contiguous"]["index"] for r in port_steps] == [0, 1, 2, 3]


def test_dryrun_multichip_world_4():
    """The port's dryrun on 4 gloo CPU ranks with JAX's init_gcn weights:
    every mode within its gates (rel < 1e-4) of the dense oracle."""
    params = {k: np.asarray(v) for k, v in
              jmodels.init_gcn(jax.random.PRNGKey(0), 32, 16, 4).items()}
    report = dryrun_multichip(4, device="cpu", params=params, timeout=240)
    for mode in ("dp_tp", "row_sharded", "ring", "hybrid", "grid2d"):
        assert report[mode]["loss_rel"] < 1e-4 and report[mode]["update_max_delta"] < 1e-4, mode

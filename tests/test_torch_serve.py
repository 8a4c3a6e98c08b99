"""The port's deployment layer on the CPU: kernels K1-K3 as registered
torch ops (`torch.library.opcheck`, gradients included), and
`export_servable` / `load_servable`, `save_bundle` / `load_bundle`,
`aot_compile` and `compiled_stats` on the GCN request, against the JAX
package's `gcn_forward` on the same parameters and features (rtol 1e-5,
atol 1e-4, the f32 class of tests/test_spmm.py:33). A bundle is also
loaded in a fresh process that imports only `voltrix_spmm_tpu_torch.serve`.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch.ops import library, spmm_block, spmm_reference
from voltrix_spmm_tpu_torch.serve import (aot_compile, compiled_stats, export_servable,
                                          load_bundle, load_servable, save_bundle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-4)
N, IN, HIDDEN, CLASSES = 700, 32, 64, 8


def power_law(n, edges, seed):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1) ** 0.8
    w /= w.sum()
    a = sp.csr_matrix((np.ones(edges, np.float32), (rng.choice(n, edges, p=w),
                                                    rng.choice(n, edges, p=w))), shape=(n, n))
    a = ((a + a.T) != 0).astype(np.float32).tocsr()
    a.sort_indices()
    return a


@pytest.fixture(scope="module")
def problem():
    a = power_law(N, 5000, seed=0)
    rng = np.random.default_rng(1)
    params = {"w1": rng.standard_normal((IN, HIDDEN)) * 0.2, "b1": rng.standard_normal(HIDDEN) * 0.1,
              "w2": rng.standard_normal((HIDDEN, CLASSES)) * 0.2,
              "b2": rng.standard_normal(CLASSES) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((N, IN)).astype(np.float32)
    gj = jmodels.build_graph(a.indptr, a.indices, N, JaxPlanConfig(), backend="numpy")
    want = np.asarray(jmodels.gcn_forward({k: jnp.asarray(v) for k, v in params.items()}, gj,
                                          jnp.asarray(x)))
    g = vt.build_graph(a.indptr, a.indices, N, vt.PlanConfig(), device="cpu")
    tparams = vt.gcn_params_from_jax(params, device="cpu")
    return a, g, tparams, torch.from_numpy(x), want


def request(g, params):
    return lambda x: vt.gcn_forward(params, g, x)


# (name, forward plan config, transpose plan config): one op a case, each
# with its gradient over a plan of another kind
OP_CASES = [
    ("spmm_block", vt.PlanConfig(128, 128), vt.PlanConfig(128, 128, gather_segment=8)),
    ("spmm_subtile", vt.PlanConfig(256, 128, block_unroll=2, cluster_cols=True),
     vt.PlanConfig(128, 128)),
    ("spmm_fused", vt.PlanConfig(256, 128, gather_segment=16, block_unroll=2),
     vt.PlanConfig(256, 128, cluster_cols=True)),
]


@pytest.mark.parametrize("kind,cfg,cfg_t", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_registered_op_opcheck(problem, kind, cfg, cfg_t):
    a = sp.random(300, 260, density=0.04, format="csr", random_state=np.random.default_rng(2))
    a.data[:] = 1.0
    at = a.T.tocsr()
    plan = vt.csr_preprocess(a.indptr, a.indices, 300, cfg, num_cols=260)
    plan_t = vt.csr_preprocess(at.indptr, at.indices, 260, cfg_t, num_cols=300)
    assert library.kind_of(plan) == kind
    cpu = torch.device("cpu")
    ops, geom = library.operands(plan, kind, cpu)
    ops_t, geom_t = library.operands(plan_t, library.kind_of(plan_t), cpu)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((260, 12)).astype(np.float32))
    op = getattr(torch.ops.voltrix, kind).default
    torch.library.opcheck(op, (x.requires_grad_(True), ops, geom, ops_t, geom_t))
    # the gradient is A^T @ grad through plan_t's op
    out = op(x, ops, geom, ops_t, geom_t)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    (out * w).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), a @ x.detach().numpy().astype(np.float64),
                               **TOL)
    np.testing.assert_allclose(x.grad.numpy(), at @ w.numpy().astype(np.float64), **TOL)


def test_op_without_transpose_refuses_its_gradient(problem):
    _, g, _, x, _ = problem
    xr = x.clone().requires_grad_(True)
    out = spmm_block(g.plan, xr)
    assert torch.equal(out.detach(), spmm_reference(g.plan, x))
    with pytest.raises(RuntimeError, match="without the transpose plan"):
        out.sum().backward()


def test_export_roundtrip_gcn_request(problem):
    _, g, params, x, want = problem
    fwd = request(g, params)
    blob = export_servable(fwd, x)
    assert isinstance(blob, bytes) and len(blob) > 0
    served = load_servable(blob)
    calls = spmm_reference.calls
    out = served(x)
    assert spmm_reference.calls - calls == 2  # K1's op, twice, inside the program
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    with torch.no_grad():
        assert torch.equal(out, fwd(x))


def test_export_polymorphic_batch():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32))

    def fwd(x):
        return torch.relu(x @ w)

    blob = export_servable(fwd, torch.ones(4, 16), polymorphic_shapes=("b, _",))
    served = load_servable(blob)
    # one program serves several batch sizes
    assert served(torch.ones(4, 16)).shape == (4, 8)
    assert served(torch.ones(32, 16)).shape == (32, 8)


def test_export_hybrid_spmm_runs_k3_and_k1(problem):
    a, _, _, x, _ = problem
    hp = vt.csr_preprocess_hybrid(a.indptr, a.indices, N)
    blob = export_servable(lambda f: vt.spmm(hp, f), x)
    program = load_servable(blob).graph
    targets = {str(n.target) for n in program.nodes if n.op == "call_function"}
    assert {"voltrix.spmm_fused.default", "voltrix.spmm_block.default"} <= targets
    np.testing.assert_allclose(load_servable(blob)(x).numpy(), a @ x.numpy().astype(np.float64),
                               **TOL)


def test_bundle_roundtrip_in_a_fresh_process(problem, tmp_path):
    _, g, params, x, want = problem
    blob = export_servable(request(g, params), x)
    path = str(tmp_path / "svc")
    save_bundle(path, blob, plan=g.plan, meta={"graph": "power-law-700", "d": IN})
    assert sorted(os.listdir(path)) == ["plan.npz", "servable.json", "servable.pt2"]
    with np.load(os.path.join(path, "plan.npz")) as z:
        assert "bitmask_packed" in z  # packed by default
    bundle = load_bundle(path)
    assert bundle.meta["graph"] == "power-law-700" and "torch_version" in bundle.meta
    assert bundle.plan.total_blocks == g.plan.total_blocks
    assert torch.equal(bundle.plan.bitmask, g.plan.bitmask)
    np.testing.assert_allclose(bundle(x).numpy(), want, **TOL)

    np.save(tmp_path / "x.npy", x.numpy())
    code = ("import sys, numpy as np, torch; from voltrix_spmm_tpu_torch.serve import load_bundle; "
            f"b = load_bundle({path!r}); "
            f"y = b(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))); "
            f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy()); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or "
            "m.startswith('voltrix_spmm_tpu.') or m == 'voltrix_spmm_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), bundle(x).numpy())


def test_bundle_without_plan(tmp_path):
    blob = export_servable(lambda x: x * 2.0, torch.ones(8, 128))
    path = str(tmp_path / "svc2")
    save_bundle(path, blob)
    bundle = load_bundle(path)
    assert bundle.plan is None
    assert torch.equal(bundle(torch.ones(8, 128)), torch.full((8, 128), 2.0))


def test_aot_compile_and_compiled_stats(problem):
    a, g, params, x, want = problem
    fwd = aot_compile(request(g, params), x)
    np.testing.assert_allclose(fwd(x).detach().numpy(), want, **TOL)
    stats = compiled_stats(fwd, x)
    # two aggregations at widths IN and HIDDEN (2 nnz d each), three products
    # of x @ W1 (2 n IN HIDDEN) and h @ W2
    nnz = g.plan.num_edges
    dense = 2 * N * IN * HIDDEN + 2 * N * HIDDEN * CLASSES
    assert stats["flops"] == 2 * nnz * IN + 2 * nnz * HIDDEN + dense
    assert stats["argument_size_in_bytes"] == x.numel() * 4
    assert stats["output_size_in_bytes"] == N * CLASSES * 4
    assert stats["peak_device_bytes"] is None  # the CPU

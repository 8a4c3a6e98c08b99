"""The port's deployment layer on the model families of paths D, E, G, H
and I, on the CPU: each request exported with `export_servable` and
loaded with `load_servable` gives logits bit for bit the eager call's and
within rtol/atol 1e-4 of the JAX package's forward on the same parameters
(`gat_forward`, `gat_dot_forward`, `gat_flash_forward` on (plan, plan_t)
and on the bare plan, `spmm(..., impl="int8")`; with bf16 planes, as path
G runs them, within the bf16 class of tests/test_torch_gat_flash.py); each
program's graph holds the registered ops of that path's kernels
(ops/library.py); D's bundle is served by a fresh process that imports no
jax; `compiled_stats` counts D's flops through K4's formula, and
`aot_compile` finds the kernels a loaded program launches.
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
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu.format import csr_preprocess as jax_csr_preprocess
from voltrix_spmm_tpu_torch.ops import library
from voltrix_spmm_tpu_torch.serve import (compiled_stats, export_servable, load_bundle,
                                          load_servable, save_bundle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 planes through two layers: float32 noise in layer 1's output can move
# a layer-2 input across a bf16 rounding boundary in one package and not in
# the other (tests/test_torch_gat_flash.py:42-46, JAX's own bf16-plane class)
BF16_MODEL_TOL = dict(rtol=2e-2, atol=2e-2)
N, IN, HIDDEN, CLASSES, HEADS = 240, 16, 8, 5, 2
CFG = (128, 128)


def gat_csr(n=N, density=0.03, seed=0):
    """Self-loops on a symmetric random graph (the GAT convention)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    a = ((a + a.T + sp.eye(n, format="csr")) != 0).astype(np.float32).tocsr()
    a.sort_indices()
    return a


def normal(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """Per path: (port request, JAX logits, the ops its program holds, the
    port's plan of A or None)."""
    a = gat_csr()
    rng = np.random.default_rng(1)
    x = normal(rng, (N, IN), 1.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    gat_p = {"w1": normal(rng, (HEADS, IN, HIDDEN), (2.0 / IN) ** 0.5),
             "a1_src": normal(rng, (HEADS, HIDDEN), HIDDEN ** -0.5),
             "a1_dst": normal(rng, (HEADS, HIDDEN), HIDDEN ** -0.5),
             "w2": normal(rng, (HEADS * HIDDEN, CLASSES), (HEADS * HIDDEN) ** -0.5),
             "a2_src": normal(rng, (CLASSES,), CLASSES ** -0.5),
             "a2_dst": normal(rng, (CLASSES,), CLASSES ** -0.5)}
    dot_p = {k: normal(rng, (HEADS, IN, HIDDEN), (2.0 / IN) ** 0.5) for k in ("wq1", "wk1", "wv1")}
    dot_p.update({k: normal(rng, (HEADS * HIDDEN, CLASSES), (HEADS * HIDDEN) ** -0.5)
                  for k in ("wq2", "wk2", "wv2")})
    jparams = {k: jnp.asarray(v) for k, v in {**gat_p, **dot_p}.items()}
    cfg_j, cfg_t = JaxPlanConfig(*CFG), vt.PlanConfig(*CFG)

    gd = vt.build_gat_graph(a.indptr, a.indices, N, vt.PlanConfig(64, 128), device="cpu")
    gdj = jmodels.build_gat_graph(a.indptr, a.indices, N, JaxPlanConfig(64, 128),
                                  backend="numpy")
    gat = vt.GAT.from_params(vt.gat_params_from_jax(gat_p, device="cpu")).eval()
    ge = vt.build_ell_graph(a.indptr, a.indices, N, vt.PlanConfig(*CFG, block_unroll=2),
                            device="cpu")
    gej = jmodels.build_ell_graph(a.indptr, a.indices, N, JaxPlanConfig(*CFG, block_unroll=2))
    dot = vt.GATDot.from_params(vt.gat_dot_params_from_jax(dot_p, device="cpu")).eval()
    flash = vt.GATFlash.from_params(vt.gat_flash_params_from_jax(dot_p, device="cpu")).eval()
    plan = vt.csr_preprocess(a.indptr, a.indices, N, cfg_t)
    jplan = jax_csr_preprocess(a.indptr, a.indices, N, cfg_j)
    return xt, {
        "D": (lambda f: gat(gd, f), jmodels.gat_forward(jparams, gdj, xj),
              ["voltrix.spmm_weighted.default"], gd.plan),
        "E": (lambda f: dot(ge, f), jmodels.gat_dot_forward(jparams, gej, xj),
              ["voltrix.spmm_ell.default", "voltrix.spmm_ell_dvals.default"], None),
        "G": (lambda f: flash((plan, plan), f),
              jmodels.gat_flash_forward(jparams, (jplan, jplan), xj),
              ["voltrix.spmm_attention_mh.default"], plan),
        "G-bf16": (lambda f: flash((plan, plan, torch.bfloat16), f),
                   jmodels.gat_flash_forward(jparams, (jplan, jplan, jnp.bfloat16), xj),
                   ["voltrix.spmm_attention_mh.default"], plan),
        "H": (lambda f: flash(plan, f), jmodels.gat_flash_forward(jparams, jplan, xj),
              ["voltrix.spmm_attention.default"], plan),
        "I": (lambda f: vt.spmm(plan, f, impl="int8"), jops.spmm(jplan, xj, impl="int8"),
              ["voltrix.spmm_int8.default"], plan),
    }


@pytest.mark.parametrize("path", ["D", "E", "G", "G-bf16", "H", "I"])
def test_exported_program_matches_eager_and_jax(models, path):
    """G and H exported where tracing the plain versions failed on the
    size of a data-dependent edge list: the ops' fakes give their shapes
    from the geometry alone."""
    x, cases = models
    fn, want, ops, _ = cases[path]
    blob = export_servable(fn, x)
    served = load_servable(blob)
    targets = sorted({str(n.target) for n in served.graph.nodes
                      if n.op == "call_function" and str(n.target).startswith("voltrix.")})
    assert targets == ops
    out = served(x)
    with torch.no_grad():
        assert torch.equal(out, fn(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               **(BF16_MODEL_TOL if path == "G-bf16" else TOL))


def test_gat_bundle_in_a_fresh_process(models, tmp_path):
    x, cases = models
    fn, want, _, plan = cases["D"]
    path = str(tmp_path / "gat")
    save_bundle(path, export_servable(fn, x), plan=plan, meta={"path": "D"})
    bundle = load_bundle(path)
    assert torch.equal(bundle.plan.bitmask, plan.bitmask)
    np.save(tmp_path / "x.npy", x.numpy())
    code = ("import sys, numpy as np, torch; from voltrix_spmm_tpu_torch.serve import load_bundle; "
            f"b = load_bundle({path!r}); "
            f"y = b(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))); "
            f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy()); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or "
            "m.startswith('voltrix_spmm_tpu.') or m == 'voltrix_spmm_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    got = np.load(tmp_path / "y.npy")
    np.testing.assert_array_equal(got, bundle(x).numpy())
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_compiled_stats_counts_gat_through_k4(models):
    """D's flops: K4's 2 nnz d for each head at layer 1 (d = HIDDEN) and at
    layer 2 (d = CLASSES), and the projections x @ W1[h] and h @ W2 (the
    logits' h @ a are matrix-vector products, which
    torch.utils.flop_counter does not count)."""
    x, cases = models
    fn, _, _, plan = cases["D"]
    nnz = plan.num_edges
    k4 = 2 * nnz * (HEADS * HIDDEN + CLASSES)
    dense = 2 * N * IN * HIDDEN * HEADS + 2 * N * HEADS * HIDDEN * CLASSES
    stats = compiled_stats(fn, x)
    assert stats["flops"] == k4 + dense
    assert stats["output_size_in_bytes"] == N * CLASSES * 4


def test_aot_compile_loads_the_kernels_a_program_launches(models):
    """`aot_compile` builds on the card the libraries of the ops in a loaded
    program's graph (`library.loaders_of`); a plain callable's warm call
    builds what it launches."""
    x, cases = models
    served = load_servable(export_servable(cases["E"][0], x))
    from voltrix_spmm_tpu_torch.ops import ell

    assert library.loaders_of(served) == [ell.load_library, ell.load_dvals_library]
    assert library.loaders_of(cases["E"][0]) == []

"""The port's command line (`python -m voltrix_spmm_tpu_torch`), after
tests/test_cli.py: main() is called in-process with `--device cpu` where a
command runs an SpMM. The plans it writes match the JAX package's CLI bit
for bit."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.__main__ import main as jax_main
from voltrix_spmm_tpu_torch.__main__ import main
from voltrix_spmm_tpu_torch.data import save_npz_graph
from voltrix_spmm_tpu_torch.format import packed_stats


def test_cli_info(capsys):
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["torch"] == torch.__version__
    assert info["device"] == ("cpu" if not torch.cuda.is_available() else info["device"])
    assert info["native_runtime"] is True and info["cxx"]
    assert info["build_dir"].endswith("kernels")
    assert "VOLTRIX_TORCH_BUILD_DIR" in info["env_flags"].values()


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_cli_preprocess_validate_roundtrip_matches_jax(tmp_path, capsys, backend):
    out = str(tmp_path / "er.plan.npz")
    assert main(["preprocess", "er-512", "-o", out, "--block-h", "32", "--backend", backend]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["plan_path"] == out and rec["num_nodes"] == 512
    assert main(["validate", out]) == 0
    assert "ok:" in capsys.readouterr().out
    jout = str(tmp_path / "er.jax.plan.npz")
    assert jax_main(["preprocess", "er-512", "-o", jout, "--block-h", "32",
                     "--backend", "numpy"]) == 0
    capsys.readouterr()
    plan, jplan = vt.SpmmPlan.load(out), jfmt.SpmmPlan.load(jout)
    np.testing.assert_array_equal(plan.bitmask.numpy().view(np.uint32), jplan.bitmask)
    np.testing.assert_array_equal(plan.hind.numpy(), jplan.hind)


def test_cli_preprocess_packed_npz_graph(tmp_path, capsys):
    """A graph written by data.save_npz_graph, preprocessed on the native
    backend into a packed plan (the deploy path's first step)."""
    a = sp.random(600, 600, density=0.02, format="csr", random_state=np.random.default_rng(0))
    a = ((a + a.T) != 0).astype(np.float32).tocsr()
    graph = save_npz_graph(str(tmp_path / "a.npz"), a)
    out = str(tmp_path / "plan.npz")
    assert main(["preprocess", graph, "--backend", "native", "--packed", "-o", out]) == 0
    rec = json.loads(capsys.readouterr().out)
    want = vt.csr_preprocess(a.indptr, a.indices, 600, backend="numpy")
    assert rec["nnz"] == a.nnz and rec["packed"] == packed_stats(want.bitmask)
    with np.load(out) as z:
        assert "bitmask_packed" in z
    assert torch.equal(vt.SpmmPlan.load(out).bitmask, want.bitmask)
    assert main(["validate", out]) == 0


def test_cli_validate_reports_a_corrupt_plan(tmp_path, capsys):
    out = str(tmp_path / "p.npz")
    assert main(["preprocess", "er-512", "-o", out, "--block-h", "32"]) == 0
    capsys.readouterr()
    with np.load(out) as z:
        arrays = dict(z)
    arrays["hind"][0, 0] = 10**6
    np.savez(out, **arrays)
    assert main(["validate", out]) == 1
    assert "INVALID: plan invariant violated: hind within" in capsys.readouterr().out


def test_cli_spmm_checks_oracle(capsys):
    assert main(["spmm", "er-512", "-d", "32", "--block-h", "32", "--device", "cpu",
                 "--time"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["difference_rate"] < 1e-4 and rec["device"] == "cpu"
    assert rec["note"] == "timing skipped on the CPU"


def test_cli_loads_tcgnn_npz(tmp_path, capsys):
    n = 300
    a = sp.random(n, n, density=0.03, format="csr", random_state=np.random.default_rng(0))
    coo = a.tocoo()
    path = str(tmp_path / "g.npz")
    np.savez(path, src_li=coo.row, dst_li=coo.col, num_nodes=n)
    assert main(["spmm", path, "-d", "16", "--block-h", "32", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["difference_rate"] < 1e-4


def test_cli_tune_refuses_and_names_the_roadmap_item(tmp_path, capsys, monkeypatch):
    """The tune command (ROADMAP.md item 9, no longer refused) prints the JAX
    package's JSON: the winning variant, its time and the candidates raced,
    and the ordering and device."""
    monkeypatch.setenv("VOLTRIX_TORCH_CACHE_DIR", str(tmp_path))
    assert main(["tune", "er-512", "-d", "32", "--device", "cpu", "--iters", "1",
                 "--budget", "0", "--reorder", "identity", "rcm"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert {"graph", "d", "variant", "time_ms", "candidates"} <= set(rec)
    assert rec["graph"] == "er-512" and rec["d"] == 32 and rec["candidates"] == 1
    assert rec["variant"].startswith("Variant(") and rec["ordering"] == "identity"
    assert any(f.startswith("tune.er-512.") for f in os.listdir(tmp_path))


def test_cli_rejects_unknown_spec():
    with pytest.raises(SystemExit):
        main(["preprocess", "nonsense-spec"])

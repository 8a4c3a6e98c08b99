"""The port's tuple API, checkpoints and profiling on the CPU: the tuple
API after tests/test_compat_checkpoint.py:14-80 against the scipy oracle
and the JAX package's `spmm_tuple`, a checkpoint round trip of a GCN's
parameters and its optimizer, and `profile_op` / `attribute_spmm` rows."""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.compat as jcompat
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch import compat
from voltrix_spmm_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint
from voltrix_spmm_tpu_torch.ops import spmm_scipy
from voltrix_spmm_tpu_torch.profiling import annotate, attribute_spmm, profile_op, trace

TOL = dict(rtol=1e-5, atol=1e-4)


def problem(n, density, d, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", random_state=rng)
    return a, rng.standard_normal((n, d)).astype(np.float32)


def test_tuple_api_matches_reference_shapes_and_jax():
    n, d = 300, 64
    a, feat = problem(n, 0.03, d, seed=0)
    cfg = vt.PlanConfig(32, 128)
    blk_offsets, hspa_packed, hind = compat.csr_preprocess_tuple(a.indptr, a.indices, n, cfg,
                                                                 device="cpu")
    total_blocks = int(blk_offsets[-1])
    assert hspa_packed.shape == (total_blocks, cfg.words_per_col, cfg.block_w)
    assert hind.shape == (total_blocks, cfg.block_w)
    out = compat.spmm_tuple(blk_offsets, hspa_packed, hind, n, a.nnz, torch.from_numpy(feat))
    np.testing.assert_allclose(out.numpy(), spmm_scipy(a.indptr, a.indices, n, feat), **TOL)
    jb, jh, jhind = jcompat.csr_preprocess_tuple(a.indptr, a.indices, n, JaxPlanConfig(32, 128))
    np.testing.assert_array_equal(hspa_packed.numpy().view(np.uint32), jh)
    np.testing.assert_array_equal(blk_offsets.numpy(), jb)
    want = np.asarray(jcompat.spmm_tuple(jb, jh, jhind, n, a.nnz, jnp.asarray(feat)))
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    assert (compat.BLK_H, compat.BLK_W) == (jcompat.BLK_H, jcompat.BLK_W)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_tuple_api_foreign_arrays(source):
    """Arrays that did not come from csr_preprocess_tuple in this process
    (copies, or the JAX package's numpy arrays) are rebuilt into a plan."""
    n, d = 200, 32
    a, feat = problem(n, 0.04, d, seed=1)
    if source == "port":
        arrays = [t.clone() for t in compat.csr_preprocess_tuple(
            a.indptr, a.indices, n, vt.PlanConfig(32, 128), device="cpu")]
    else:
        arrays = [np.array(t) for t in jcompat.csr_preprocess_tuple(
            a.indptr, a.indices, n, JaxPlanConfig(32, 128))]
    out = compat.spmm_tuple(*arrays, n, a.nnz, torch.from_numpy(feat))
    np.testing.assert_allclose(out.numpy(), spmm_scipy(a.indptr, a.indices, n, feat), **TOL)


def test_tuple_api_refuses_an_inconsistent_geometry():
    n = 200
    a, feat = problem(n, 0.04, 8, seed=2)
    blk, hspa, hind = compat.csr_preprocess_tuple(a.indptr, a.indices, n,
                                                  vt.PlanConfig(16, 128), device="cpu")
    with pytest.raises(ValueError, match="cannot reconstruct plan geometry"):
        compat.spmm_tuple(blk.clone(), hspa, hind, n, a.nnz, torch.from_numpy(feat))


def test_tuple_api_plan_dies_with_its_array():
    n, d = 160, 16
    a1, _ = problem(n, 0.05, d, seed=3)
    blk1, _, _ = compat.csr_preprocess_tuple(a1.indptr, a1.indices, n, vt.PlanConfig(32, 128),
                                             device="cpu")
    plan_ref = weakref.ref(blk1._voltrix_plan)
    del blk1
    gc.collect()
    assert plan_ref() is None, "the plan must die with its blk_offsets tensor"
    a2, feat = problem(n, 0.08, d, seed=4)
    blk2, hspa2, hind2 = compat.csr_preprocess_tuple(a2.indptr, a2.indices, n,
                                                     vt.PlanConfig(32, 128), device="cpu")
    out = compat.spmm_tuple(blk2, hspa2, hind2, n, a2.nnz, torch.from_numpy(feat))
    np.testing.assert_allclose(out.numpy(), spmm_scipy(a2.indptr, a2.indices, n, feat), **TOL)


def test_checkpoint_roundtrip(tmp_path):
    model = vt.GCN(16, 32, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    model.params()["w1"].sum().backward()
    opt.step()
    state = {"params": {k: v.detach() for k, v in model.params().items()},
             "opt": opt.state_dict(), "step": torch.tensor(1)}
    path = save_checkpoint(str(tmp_path / "ckpt" / "state.pt"), state)
    assert not [f for f in (tmp_path / "ckpt").iterdir() if ".tmp." in f.name]
    back = load_checkpoint(path)
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k], v)
    assert torch.equal(back["opt"]["state"][0]["exp_avg"], opt.state_dict()["state"][0]["exp_avg"])
    like = {"params": {k: v.double() for k, v in state["params"].items()},
            "opt": state["opt"], "step": state["step"]}
    assert load_checkpoint(path, like=like)["params"]["w1"].dtype == torch.float64
    # a module's state_dict, restored into a fresh module
    save_checkpoint(str(tmp_path / "model.pt"), model)
    fresh = vt.GCN(16, 32, 4, generator=torch.Generator().manual_seed(9), device="cpu")
    load_checkpoint(str(tmp_path / "model.pt"), like=fresh)
    assert all(torch.equal(fresh.params()[k], model.params()[k]) for k in ("w1", "b1", "w2", "b2"))


def test_profile_op_rows_and_attribution(tmp_path):
    n, d = 400, 16
    a, feat = problem(n, 0.03, d, seed=5)
    plan = vt.csr_preprocess(a.indptr, a.indices, n)
    x = torch.from_numpy(feat)
    table = profile_op(lambda f: vt.spmm(plan, f), x, iters=2, warmup=1)
    assert table and all(set(r) == {"op", "ms_per_iter", "count"} for r in table)
    assert table == sorted(table, key=lambda r: -r["ms_per_iter"])
    names = {r["op"] for r in table}
    assert "voltrix::spmm_block" in names and "aten::index_select" in names
    split = attribute_spmm(table, plan)
    assert split["kernel_ms"] > 0 and split["gather_ms"] > 0
    assert split["total_ms"] == pytest.approx(sum(r["ms_per_iter"] for r in table))
    with trace(str(tmp_path / "tr")), annotate("request"):
        vt.spmm(plan, x)
    assert list((tmp_path / "tr").glob("trace_*.json"))


def test_nvcc_times_builds_each_source_of_each_checkout(tmp_path, monkeypatch, capsys):
    """tools/nvcc_times.py times every .cu of each --csrc side by side, each
    into a library of its own (two checkouts' sources of one name do not
    share an output), prints their seconds as JSON, and exits 1 when nvcc
    fails on one (an nvcc stand-in that records its -o and fails bad.cu)."""
    import json
    import stat
    import sys

    from voltrix_spmm_tpu_torch.project import const
    from voltrix_spmm_tpu_torch.tools import nvcc_times

    log = tmp_path / "outs.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    f"open({str(log)!r}, 'a').write(out + '\\n')\n"
                    "sys.exit(1 if sys.argv[-1].endswith('bad.cu') else 0)\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv(const.NVCC_FLAG, str(fake))
    dirs = [tmp_path / "parent" / "csrc", tmp_path / "change" / "csrc"]
    for d in dirs:
        d.mkdir(parents=True)
        for name in ("a.cu", "b.cu", "walk.cuh"):
            (d / name).write_text("")
    nvcc_times.main([arg for d in dirs for arg in ("--csrc", str(d))])
    times = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(times) == sorted(f"{d}/{s}" for d in dirs for s in ("a.cu", "b.cu"))
    assert all(t >= 0 for t in times.values())
    outs = log.read_text().split()
    assert len(outs) == 4 and len(set(outs)) == 4
    (dirs[1] / "bad.cu").write_text("")
    with pytest.raises(SystemExit):
        nvcc_times.main(["--csrc", str(dirs[1]), "a.cu", "bad.cu"])
    assert "bad.cu: " in capsys.readouterr().out

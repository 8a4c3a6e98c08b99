"""The port's attention tuner (voltrix_spmm_tpu_torch/tuner/attention.py)
against the JAX package's on the CPU, after tests/test_tuner.py:472-538.
The port races K13-K15's plain versions on CPU tensors; the JAX side runs
its Pallas kernels in interpret mode. The tuned op and its gradients are
held to JAX's at K13-K15's tolerances (tests/test_torch_attention_mh.py):
out at rtol 1e-5 / atol 1e-6 with float32 planes and rtol 1e-4 / atol 1e-5
with bf16 planes; gradients at rtol 1e-4 / atol 1e-5 with float32 planes and
max error over max magnitude < 1e-3 with bf16 planes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.tuner.attention as jattn
import voltrix_spmm_tpu_torch.tuner.attention as tattn
from voltrix_spmm_tpu_torch.tuner import AttnVariant
from voltrix_spmm_tpu_torch.tuner.attention import AttentionTuner, attention_default_space

OUT_TOL = {None: dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-4, atol=1e-5)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def tiny_space():
    return [AttnVariant(block_h=32, block_unroll=1), AttnVariant(block_h=64, block_unroll=1),
            AttnVariant(block_h=32, block_unroll=1, plane_dtype="bfloat16")]


@pytest.fixture
def attn_problem(rng):
    n = 192
    a = sp.random(n, n, density=0.06, format="csr", random_state=rng)
    return a, a.T.tocsr()


def qkv(heads, n, dk, dv, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((heads, n, w)).astype(np.float32) for w in (dk, dk, dv)]


def tune(tmp_path, a, at, **kw):
    kw = {"heads": 2, "dk": 8, "dv": 12, "mode": "fwd", "iters": 1, **kw}
    return AttentionTuner(cache_dir=str(tmp_path)).compile_and_tune(
        a.indptr, a.indices, a.shape[0], at_indptr=at.indptr, at_indices=at.indices,
        device="cpu", **kw)


@pytest.mark.parametrize("accurate", [False, True])
def test_default_space_equals_jax(accurate):
    ours = [v.key() for v in attention_default_space(accurate=accurate)]
    assert ours == [v.key() for v in jattn.attention_default_space(accurate=accurate)]
    assert len(ours) == (15 if not accurate else 7)


def test_attention_tuned_correct(attn_problem, tmp_path):
    """The tuned callable against JAX's op on the winner's geometry, the
    race's times per candidate, a real winner."""
    a, at = attn_problem
    tuned = tune(tmp_path, a, at, space=tiny_space())
    assert tuned.time_ms > 0 and len(tuned.candidates) == 3
    assert tuned.variant in tiny_space()
    q, k, v = qkv(2, a.shape[0], 8, 12)
    got = tuned(*map(torch.from_numpy, (q, k, v))).detach().numpy()
    jtuned = jattn.AttentionTuner(cache_dir=str(tmp_path / "jax")).compile_and_tune(
        a.indptr, a.indices, a.shape[0], at_indptr=at.indptr, at_indices=at.indices,
        heads=2, dk=8, dv=12, mode="fwd", space=[jattn.AttnVariant(**vars_of(tuned.variant))],
        iters=1)
    want = np.asarray(jtuned(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, **OUT_TOL[tuned.variant.plane_dtype])


def vars_of(v):
    return dict(block_h=v.block_h, block_unroll=v.block_unroll, plane_dtype=v.plane_dtype,
                subtile=v.subtile)


def test_attention_tuner_cache(attn_problem, tmp_path):
    a, at = attn_problem
    t0 = AttentionTuner(cache_dir=str(tmp_path))
    kw = dict(at_indptr=at.indptr, at_indices=at.indices, heads=2, dk=8, dv=12, mode="fwd",
              space=tiny_space(), iters=1, device="cpu")
    t1 = t0.compile_and_tune(a.indptr, a.indices, a.shape[0], **kw)
    assert t0.compile_and_tune(a.indptr, a.indices, a.shape[0], **kw) is t1
    entries = [f for f in os.listdir(tmp_path) if f.startswith("tune_attn.")]
    assert len(entries) == 1 and ".cpu." in entries[0]
    t2 = AttentionTuner(cache_dir=str(tmp_path)).compile_and_tune(
        a.indptr, a.indices, a.shape[0], **kw)
    assert t2 is not t1 and t2.variant == t1.variant
    assert set(t2.candidates) == set(t1.candidates)


def test_attention_train_mode(attn_problem, tmp_path):
    a, at = attn_problem
    tuned = tune(tmp_path, a, at, dv=8, mode="train",
                 space=[AttnVariant(block_h=32, block_unroll=1)])
    assert tuned.time_ms > 0 and np.isfinite(tuned.time_ms)


@pytest.mark.parametrize("variant,directed", [
    (AttnVariant(32, 1), True),
    (AttnVariant(64, 2, "bfloat16"), False),
    (AttnVariant(128, 1, None, subtile=True), False),
])
def test_tuned_attention_out_and_gradients_match_jax(variant, directed, tmp_path):
    """A one-variant space in both packages, mode "train": the port's
    TunedAttention out and gradients against JAX's TunedAttention and
    jax.grad, on a directed graph with its own transpose plan and on a
    symmetric one (the forward plan serves both)."""
    rng = np.random.default_rng(3)
    n, heads, dk, dv = 300, 2, 8, 12
    a = sp.random(n, n, density=0.04, format="csr", random_state=rng)
    a = (a != 0).astype(np.float32).tocsr()
    if not directed:
        a = ((a + a.T) != 0).astype(np.float32).tocsr()
    at = a.T.tocsr() if directed else None
    tkw = {} if at is None else dict(at_indptr=at.indptr, at_indices=at.indices)
    ours = AttentionTuner(cache_dir=str(tmp_path / "t")).compile_and_tune(
        a.indptr, a.indices, n, heads=heads, dk=dk, dv=dv, mode="train", space=[variant],
        iters=1, device="cpu", **tkw)
    theirs = jattn.AttentionTuner(cache_dir=str(tmp_path / "j")).compile_and_tune(
        a.indptr, a.indices, n, heads=heads, dk=dk, dv=dv, mode="train",
        space=[jattn.AttnVariant(**vars_of(variant))], iters=1, **tkw)
    assert (ours.plan_t is ours.plan) == (not directed)
    q, k, v = qkv(heads, n, dk, dv, seed=4)
    w = np.random.default_rng(5).standard_normal((heads, n, dv)).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ours(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    want_out, grads = jax.value_and_grad(
        lambda *t: jnp.sum(theirs(*t) * w), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(theirs(*map(jnp.asarray,
                                                                            (q, k, v)))),
                               **OUT_TOL[variant.plane_dtype])
    for got, ref, name in zip(leaves, grads, "qkv"):
        ref = np.asarray(ref)
        if variant.plane_dtype is None:
            np.testing.assert_allclose(got.grad.numpy(), ref, **GRAD_TOL, err_msg=f"d{name}")
        else:
            err = np.abs(got.grad.numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-3, f"d{name}: {err:.3e}"


def test_attention_invalid_candidate_skipped(attn_problem, tmp_path):
    """subtile=True needs block_h % 128 == 0: a ValueError, the candidate
    skipped (NaN, as in JAX) and its reason kept."""
    a, at = attn_problem
    bad = AttnVariant(block_h=32, block_unroll=1, subtile=True)
    tuned = tune(tmp_path, a, at, space=[bad, AttnVariant(block_h=32, block_unroll=1)])
    assert np.isnan(tuned.candidates[bad.key()]) and not tuned.variant.subtile
    assert tuned.errors[bad.key()].startswith("ValueError")
    with pytest.raises(RuntimeError, match="no valid candidate"):
        tune(tmp_path / "none", a, at, space=[bad])


def test_attention_launch_failure_stops_the_race(attn_problem, tmp_path, monkeypatch):
    a, at = attn_problem
    import voltrix_spmm_tpu_torch.ops.attention_mh as mh

    def broken(*_a, **_k):
        raise RuntimeError("spmm_attention_mh launch failed: unspecified launch failure")

    monkeypatch.setattr(mh, "spmm_attention_mh_ad", broken)
    with pytest.raises(RuntimeError, match="the race stops.*unspecified launch failure"):
        tune(tmp_path, a, at, space=tiny_space())


def test_attention_budget_early_stop(attn_problem, tmp_path):
    a, at = attn_problem
    tuned = tune(tmp_path, a, at, space=tiny_space(), budget_s=0.0)
    assert len(tuned.candidates) == 1 and tuned.variant == tiny_space()[0]


def test_attention_signature_and_mode(attn_problem, tmp_path):
    a, at = attn_problem
    tune(tmp_path, a, at, space=tiny_space()[:1], hash_tag="g")
    tune(tmp_path, a, at, space=tiny_space()[:1], hash_tag="g", dv=8, mode="train")
    entries = sorted(f for f in os.listdir(tmp_path) if f.startswith("tune_attn.g."))
    assert len(entries) == 2 and any(".train." in f for f in entries)
    with pytest.raises(ValueError, match="mode"):
        tune(tmp_path, a, at, mode="bwd")
    assert tattn._matrix_hash(a.indptr, a.indices, a.shape[0]) == jattn._matrix_hash(
        a.indptr, a.indices, a.shape[0])

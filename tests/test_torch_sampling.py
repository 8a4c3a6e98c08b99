"""Parity of the PyTorch port's neighbour sampler and mini-batch GraphSAGE
with the JAX package on the CPU.

The same numpy seed gives the same sampled plans, transposes, inverse
degrees and source lists bit for bit, padding included, and leaves the
generator in the same state. The mini-batch forward, loss and gradients
go through K1's plain version on the port's side and `spmm_pallas` in
interpret mode on the JAX side: logits at rtol 1e-4, atol 1e-4
(tests/test_torch_gcn.py), gradients at rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu.data.sampling as jsamp
import voltrix_spmm_tpu.models as jmodels
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.data as tdata
from voltrix_spmm_tpu.format import PlanConfig as JaxPlanConfig
from voltrix_spmm_tpu_torch.data import sampling as tsamp

from test_torch_format import assert_same_plan

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def community_graph(n=400, comm=4, deg=12, seed=0):
    """tests/test_sampling.py's graph: 90% of the edges inside a community;
    plus a few isolated nodes (degree 0)."""
    rng = np.random.default_rng(seed)
    size = n // comm
    src = np.repeat(np.arange(n), deg)
    intra = (src // size) * size + rng.integers(0, size, size=src.shape[0])
    rand = rng.integers(0, n, size=src.shape[0])
    dst = np.where(rng.random(src.shape[0]) < 0.9, intra, rand)
    keep = (src % 97 != 5) & (dst % 97 != 5)  # nodes 5, 102, ... are isolated
    a = sp.csr_matrix((np.ones(keep.sum(), np.float32), (src[keep], dst[keep])), shape=(n, n))
    a = ((a + a.T) != 0).astype(np.float32).tocsr()
    labels = (np.arange(n) // size).astype(np.int64)
    return a, labels


def assert_same_block(jb, tb):
    assert_same_plan(jb.plan, tb.plan)
    assert_same_plan(jb.plan_t, tb.plan_t)
    np.testing.assert_array_equal(tb.inv_deg, jb.inv_deg)
    assert tb.inv_deg.dtype == np.float32 and tb.src_ids.dtype == np.int32
    np.testing.assert_array_equal(tb.src_ids, jb.src_ids)
    assert (tb.num_dst, tb.num_src) == (jb.num_dst, jb.num_src)


@pytest.mark.parametrize("num_dst,num_src,fanout,cfg", [
    (40, 240, 5, (32, 128)),
    (512, 13312, 25, (32, 128)),
    (13312, 146432, 10, (32, 128)),
    (7, 21, 2, (128, 128)),
    (300, 3300, 10, (64, 256)),
])
def test_block_caps_match_jax(num_dst, num_src, fanout, cfg):
    assert (tdata.block_caps(num_dst, num_src, fanout, vt.PlanConfig(*cfg))
            == jsamp.block_caps(num_dst, num_src, fanout, JaxPlanConfig(*cfg)))


@pytest.mark.parametrize("case", ["seeds", "padding and repeats", "hubs", "tall windows"])
def test_sample_block_matches_jax(case):
    a, _ = community_graph()
    pick = np.random.default_rng(1)
    fanout, cfg = 5, (32, 128)
    dst = pick.choice(400, size=40, replace=False)
    if case == "padding and repeats":  # -1 rows sample nothing; a repeat keeps its first slot
        dst = np.concatenate([dst[:30], [-1, -1, dst[3], 5, -1, dst[7]], dst[30:34]])
    if case == "hubs":  # every node has more than fanout neighbours: rng.choice each
        fanout = 3
    if case == "tall windows":
        cfg = (128, 128)
    jb = jsamp.sample_block(a.indptr, a.indices, dst, fanout, np.random.default_rng(7),
                            JaxPlanConfig(*cfg))
    rng = np.random.default_rng(7)
    tb = tdata.sample_block(a.indptr, a.indices, dst, fanout, rng, vt.PlanConfig(*cfg))
    assert_same_block(jb, tb)
    # padding: zero-bit blocks in the last window up to the cap
    cap_f, cap_t = tdata.block_caps(tb.num_dst, tb.num_src, fanout, vt.PlanConfig(*cfg))
    assert tb.plan.total_blocks == cap_f and tb.plan_t.total_blocks == cap_t
    assert tb.plan.num_edges == tb.plan_t.num_edges == len(dst) * fanout
    # the generator drew the same numbers: the same state after
    ref = np.random.default_rng(7)
    jsamp.sample_block(a.indptr, a.indices, dst, fanout, ref, JaxPlanConfig(*cfg))
    assert rng.integers(0, 2**62) == ref.integers(0, 2**62)


def test_sample_blocks_match_jax():
    a, _ = community_graph()
    seeds = np.random.default_rng(2).choice(400, size=24, replace=False)
    jbs = jsamp.sample_blocks(a.indptr, a.indices, seeds, [4, 3], np.random.default_rng(11))
    tbs = tdata.sample_blocks(a.indptr, a.indices, seeds, [4, 3], np.random.default_rng(11))
    assert len(tbs) == 2
    for jb, tb in zip(jbs, tbs):
        assert_same_block(jb, tb)
    # fanouts[-1] samples the seed hop; each hop's dst list is the next one's sources
    assert tbs[1].num_dst == 24 and tbs[1].num_src == 24 * 4
    assert tbs[0].num_dst == tbs[1].num_src and tbs[0].num_src == 96 * 5


def test_gather_features_matches_jax():
    x = np.random.default_rng(3).standard_normal((50, 6)).astype(np.float32)
    ids = np.array([3, -1, 49, 0, -1, 7], np.int32)
    want = jsamp.gather_features(x, ids)
    got = tdata.gather_features(x, ids)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got_t = tdata.gather_features(torch.from_numpy(x), ids)
    np.testing.assert_array_equal(got_t.numpy(), want)


def both_minibatch(fanouts=(4, 3), dims=(16, 12, 4), seed=0):
    a, labels = community_graph()
    seeds = np.random.default_rng(seed).choice(400, size=24, replace=False)
    jbs = jsamp.sample_blocks(a.indptr, a.indices, seeds, list(fanouts),
                              np.random.default_rng(seed + 1))
    tbs = tdata.sample_blocks(a.indptr, a.indices, seeds, list(fanouts),
                              np.random.default_rng(seed + 1))
    x = np.random.default_rng(seed + 2).standard_normal((400, dims[0])).astype(np.float32)
    x_src = jsamp.gather_features(x, jbs[0].src_ids)
    pj = jmodels.init_sage_minibatch(jax.random.PRNGKey(seed), list(dims))
    pj = [{k: np.asarray(v) + (0.1 if k == "b" else 0.0) for k, v in p.items()} for p in pj]
    return a, jbs, tbs, x, x_src, labels[seeds], pj


def test_sage_minibatch_forward_and_loss_match_jax():
    _, jbs, tbs, _, x_src, y, pj = both_minibatch()
    pt = vt.sage_minibatch_params_from_jax(pj, device="cpu")
    want = jmodels.sage_minibatch_forward(pj, jbs, jnp.asarray(x_src))
    got = vt.sage_minibatch_forward(pt, tbs, torch.from_numpy(x_src))
    assert got.shape == (24, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    want_loss = jmodels.sage_minibatch.sage_minibatch_loss(pj, jbs, jnp.asarray(x_src),
                                                           jnp.asarray(y))
    got_loss = vt.sage_minibatch_loss(pt, tbs, torch.from_numpy(x_src), torch.from_numpy(y))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("input_grad", [False, True])
def test_sage_minibatch_gradients_match_jax(input_grad):
    _, jbs, tbs, _, x_src, y, pj = both_minibatch(seed=3)
    loss_j = jmodels.sage_minibatch.sage_minibatch_loss
    gp, gx = jax.grad(loss_j, argnums=(0, 2))(pj, jbs, jnp.asarray(x_src), jnp.asarray(y))
    pt = vt.sage_minibatch_params_from_jax(pj, device="cpu")
    for p in pt:
        for v in p.values():
            v.requires_grad_(True)
    xt = torch.from_numpy(x_src).requires_grad_(input_grad)
    vt.sage_minibatch_loss(pt, tbs, xt, torch.from_numpy(y)).backward()
    for p_t, p_j in zip(pt, gp):
        for k in p_t:
            np.testing.assert_allclose(p_t[k].grad.numpy(), np.asarray(p_j[k]), **GRAD_TOL,
                                       err_msg=k)
    if input_grad:  # through blocks[0]'s transpose plan
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    else:
        assert xt.grad is None


def test_blocks_args_leaves_the_deep_transpose():
    _, _, tbs, _, _, _, _ = both_minibatch()
    plans, inv_degs = vt.blocks_args(tbs, "cpu")
    assert plans[0][1] is tbs[0].plan_t  # never read without the features' gradient
    assert plans[1][1] is not tbs[1].plan_t
    plans, _ = vt.blocks_args(tbs, "cpu", input_grad=True)
    assert plans[0][1] is not tbs[0].plan_t
    assert [tuple(d.shape) for d in inv_degs] == [(96, 1), (24, 1)]


def test_sage_minibatch_step_matches_optax_sgd():
    _, jbs, tbs, _, x_src, y, pj = both_minibatch(seed=5)
    opt = optax.sgd(0.5)
    step_j = jmodels.make_sage_minibatch_step(opt)
    plans_j, invd_j = jmodels.blocks_args(jbs)
    new_j, _, loss_j = step_j(pj, opt.init(pj), plans_j, invd_j, jnp.asarray(x_src),
                              jnp.asarray(y))
    model = vt.SageMinibatch.from_params(vt.sage_minibatch_params_from_jax(pj, device="cpu"))
    step = vt.make_sage_minibatch_step(torch.optim.SGD(model.parameters(), lr=0.5))
    plans, invd = vt.blocks_args(tbs, "cpu")
    loss = step(model.params(), plans, invd, torch.from_numpy(x_src), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for p_t, p_j in zip(model.params(), new_j):
        for k in p_t:
            np.testing.assert_allclose(p_t[k].detach().numpy(), np.asarray(p_j[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_sage_inference_matches_jax():
    a, _, _, x, _, _, pj = both_minibatch()
    gj = jmodels.build_graph(a.indptr, a.indices, 400, JaxPlanConfig(32, 128), backend="numpy")
    gt = vt.build_graph(a.indptr, a.indices, 400, vt.PlanConfig(32, 128), device="cpu")
    want = jmodels.sage_inference(pj, gj, jnp.asarray(x))
    got = vt.sage_inference(vt.sage_minibatch_params_from_jax(pj, device="cpu"), gt,
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sage_minibatch_module_init():
    def make(seed):
        return vt.SageMinibatch([20, 16, 5], generator=torch.Generator().manual_seed(seed),
                                device="cpu")

    m1, m2, m3 = make(0), make(0), make(1)
    p1, p2 = m1.params(), m2.params()
    assert [sorted(p) for p in p1] == [["b", "w_neigh", "w_self"]] * 2
    assert tuple(p1[0]["w_self"].shape) == (20, 16) and tuple(p1[1]["w_neigh"].shape) == (16, 5)
    assert all(torch.equal(p1[i][k], p2[i][k]) for i in range(2) for k in p1[i])
    assert not torch.equal(m1.params()[0]["w_self"], m3.params()[0]["w_self"])
    assert not p1[0]["b"].any()
    assert len(list(m1.parameters())) == 6


def test_sampling_helpers_split_like_sample_block():
    """_sample_edges then _block_plans is sample_block (chip_smoke.py times
    the two halves apart)."""
    a, _ = community_graph()
    dst = np.arange(0, 400, 9)
    whole = tdata.sample_block(a.indptr, a.indices, dst, 4, np.random.default_rng(4))
    parts = tsamp._block_plans(*tsamp._sample_edges(a.indptr, a.indices, dst, 4,
                                                    np.random.default_rng(4)),
                               4, vt.PlanConfig(32, 128))
    for name in ("bitmask", "hind", "block_ptr", "window_of_block"):
        assert torch.equal(getattr(whole.plan, name), getattr(parts.plan, name))
        assert torch.equal(getattr(whole.plan_t, name), getattr(parts.plan_t, name))
    np.testing.assert_array_equal(whole.src_ids, parts.src_ids)

"""The work list that kernels K1, K2, K4 and K8 share (ops/block_spmm.py:
window_pieces, walk_tasks, plan_walk), on the CPU; K3's slabs of it, and
K9's, K10's, K13's, K14's and K15's (ops/attention.py:attention_walk),
whose piece emulations against the JAX package are in
tests/test_torch_attention.py and tests/test_torch_attention_mh.py; K5's
(a block limit alone), whose emulation is in tests/test_torch_weighted.py.

Each window's blocks are cut into pieces of at most P consecutive blocks,
and the pieces' float32 tiles are summed in piece order. The kernels run
only on the card (chip_smoke.py holds them to their plain versions); here
a plain emulation of the split (each task's blocks summed with the plain
version of K1 or K2, then the pieces added in order) is held to the JAX
package's `spmm_pallas` in interpret mode, to the tolerance of
tests/test_spmm.py:51-52 (float32 sums taken in another order); K8's split
likewise, on the rows that `spmm_int8_reference` dequantizes, against
`spmm_pallas_int8` as tests/test_quant.py runs it; K4's (pieces of whole
value tiles, no work limit) with the plain version of K4 against
`spmm_pallas_weighted` as tests/test_weighted.py runs it; K3's (slabs of
256 rows on windows taller than 128 rows, `group_words`) with the plain
version of K3 against `spmm_pallas_fused` as tests/test_torch_fused.py runs
it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import voltrix_spmm_tpu as jvx
import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.format.stream import slice_plan_windows
from voltrix_spmm_tpu_torch.ops import (
    spmm_fused_reference,
    spmm_int8_reference,
    spmm_reference,
    spmm_subtile_reference,
    spmm_weighted_reference,
)
from voltrix_spmm_tpu_torch.ops.attention import SHARE_KERNELS, attention_walk
from voltrix_spmm_tpu_torch.ops.block_spmm import (
    MAX_PIECE_BLOCKS,
    PIECE_BLOCKS,
    PIECE_WORK,
    block_work,
    group_words,
    plan_walk,
    walk_tasks,
    window_pieces,
)
from voltrix_spmm_tpu_torch.ops.fused_spmm import box_rows
from voltrix_spmm_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from voltrix_spmm_tpu_torch.ops.subtile_spmm import subtile_occupancy, subtile_walk

TOL = dict(rtol=1e-5, atol=1e-4)
N = 3000


def power_law():
    """A symmetrised Chung-Lu graph: its first window holds the hubs."""
    return symmetrize(chung_lu_csr(N, 30000, seed=3))


def csr_args(a):
    return a.indptr, a.indices, a.shape[0]


def both_plans(a, **cfg):
    n = a.shape[0]
    jplan = jvx.csr_preprocess(a.indptr, a.indices, n, jvx.PlanConfig(**cfg), backend="numpy")
    return jplan, vt.csr_preprocess(a.indptr, a.indices, n, vt.PlanConfig(**cfg))


def features(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def assert_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert vt.calc_diff(out, ref) < 1e-6
    np.testing.assert_allclose(out, ref, **TOL)


def groups_of(plan):
    return -(-plan.config.words_per_col // 4)


def occupancy(plan):
    return plan.occ if plan.occ is not None else subtile_occupancy(plan.bitmask)


def by_group(tasks):
    """(window, group) -> the group's task rows in piece order."""
    groups = {}
    for row in tasks.tolist():
        groups.setdefault((row[0], row[1]), []).append(row)
    return {k: sorted(v, key=lambda r: r[4]) for k, v in groups.items()}


def emulate(plan, x, subtile, piece_blocks, piece_work=None, gw=4, plain=None):
    """The kernels' split in plain torch: each task's blocks summed by the
    plain version of K1 (K2 with `subtile`, per-block skip; K4 on a plan
    with a value plane; `plain` if given, K3's) into its group of `gw`
    32-row words, and each group's pieces added in piece order."""
    cfg = plan.config
    occ = occupancy(plan) if subtile else None
    work = None if piece_work is None else block_work(plan, gw).numpy()
    groups_n = -(-cfg.words_per_col // gw)
    tasks, _, _ = walk_tasks(plan.block_ptr.numpy(), piece_blocks, groups_n,
                             None if occ is None else occ.numpy(), work, piece_work)
    if plain is None:
        plain = spmm_subtile_reference if subtile else spmm_reference
        if plan.values is not None:
            plain = spmm_weighted_reference
    per_block = dataclasses.replace(cfg, block_unroll=1)  # K2 skips block by block
    groups = by_group(tasks)
    assert set(groups) == {(w, g) for w in range(plan.num_windows) for g in range(groups_n)}
    out = torch.zeros(plan.num_nodes, x.shape[1])
    for (w, g), rows in groups.items():
        assert [r[4] for r in rows] == list(range(len(rows)))
        r0 = w * cfg.block_h + 32 * gw * g
        span = slice(r0, min(r0 + 32 * gw, (w + 1) * cfg.block_h, plan.num_nodes))
        acc = None
        for _, _, b0, b1, _, _ in rows:
            sub = dataclasses.replace(
                plan, config=per_block, bitmask=plan.bitmask[b0:b1], hind=plan.hind[b0:b1],
                window_of_block=plan.window_of_block[b0:b1], total_blocks=b1 - b0,
                occ=None if occ is None else occ[b0:b1],
                values=None if plan.values is None else plan.values[b0:b1])
            part = plain(sub, x)[span]
            acc = part if acc is None else acc + part
        out[span] = acc
    return out


@pytest.mark.parametrize("piece_blocks", [1, 2, 3, 8, 64])
def test_pieces_cover_each_window_once_in_order(piece_blocks):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 32))
    bp = plan.block_ptr.numpy()
    window, begin, end, visits = window_pieces(bp, piece_blocks)
    assert np.array_equal(visits, end - begin)
    assert np.all(np.diff(window) >= 0)
    assert np.all(end - begin <= piece_blocks)
    for w in range(plan.num_windows):
        mine = window == w
        b, e = begin[mine], end[mine]
        assert b[0] == bp[w] and e[-1] == bp[w + 1]
        assert np.array_equal(b[1:], e[:-1])  # consecutive, no gap, no overlap
        if bp[w + 1] > bp[w]:
            assert np.all(e > b)


def test_hub_window_splits_into_many_pieces():
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 32))
    window, *_ = window_pieces(plan.block_ptr.numpy(), 4)
    assert np.bincount(window)[0] >= 8


@pytest.mark.parametrize("piece_blocks", [1, 4])
def test_empty_window_gets_one_empty_piece(piece_blocks):
    bp = np.array([0, 5, 5, 5, 12, 12])
    window, begin, end, _ = window_pieces(bp, piece_blocks)
    for w in (1, 2, 4):
        assert np.sum(window == w) == 1
        assert begin[window == w] == end[window == w] == bp[w]
    assert np.sum(window == 0) == -(-5 // piece_blocks)


@pytest.mark.parametrize("subtile", [False, True])
def test_plan_without_blocks_gets_one_empty_piece_per_group(subtile):
    bp = np.zeros(5, np.int64)
    work = np.zeros((0, 2), np.int64)
    tasks, merges, slots = walk_tasks(bp, 4, 2, np.zeros(0, np.int32) if subtile else None,
                                      work, 100)
    assert slots == 0 and merges.shape == (0, 4)
    assert sorted(map(tuple, tasks[:, :2].tolist())) == [(w, g) for w in range(4) for g in (0, 1)]
    assert np.all(tasks[:, 2:4] == 0) and np.all(tasks[:, 4:6] == [0, -1])


@pytest.mark.parametrize("num_chunks", [2, 3, 4])
def test_pieces_in_a_window_chunk_equal_the_whole_plans(num_chunks):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 32))
    bp = plan.block_ptr.numpy()
    whole = window_pieces(bp, 3)
    w0 = 0
    for sub in slice_plan_windows(plan, num_chunks):
        window, begin, end, _ = window_pieces(sub.block_ptr.numpy(), 3)
        mine = (whole[0] >= w0) & (whole[0] < w0 + sub.num_windows)
        b_off = bp[w0]
        assert np.array_equal(window + w0, whole[0][mine])
        assert np.array_equal(begin + b_off, whole[1][mine])
        assert np.array_equal(end + b_off, whole[2][mine])
        w0 += sub.num_windows


@pytest.mark.parametrize("piece_work", [None, 300])
@pytest.mark.parametrize("subtile", [False, True])
@pytest.mark.parametrize("piece_blocks", [2, 5])
def test_walk_tasks_cover_each_group(subtile, piece_blocks, piece_work):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(256, 32, cluster_cols=subtile))
    occ = occupancy(plan).numpy().astype(np.int64) if subtile else None
    work = block_work(plan).numpy()
    tasks, merges, slots = walk_tasks(plan.block_ptr.numpy(), piece_blocks, 2, occ,
                                      None if piece_work is None else work, piece_work)
    bp = plan.block_ptr.numpy()
    cut = {(w, g): (first, count) for w, g, first, count in merges.tolist()}
    used_slots = []
    groups = by_group(tasks)
    assert set(groups) == {(w, g) for w in range(plan.num_windows) for g in range(2)}
    for (w, g), rows in groups.items():
        mine = np.array(rows)
        count = len(mine)
        assert np.all(mine[:, 4] == np.arange(count))
        assert np.all((mine[:, 2] >= bp[w]) & (mine[:, 3] <= bp[w + 1]))
        assert np.all(mine[1:, 2] >= mine[:-1, 3])  # in block order, no overlap
        # every block with the group's bit is walked, by exactly one task;
        # no task walks more than piece_blocks, nor much more than piece_work
        walked = [np.arange(b0, b1) for b0, b1 in mine[:, 2:4]]
        if subtile:
            walked = [b[(occ[b] >> g) & 1 == 1] for b in walked]
        assert max(len(b) for b in walked) <= piece_blocks
        if piece_work is not None:
            assert all(work[b, g].sum() <= piece_work + work[b, g].max(initial=0)
                       for b in walked)
        want = np.arange(bp[w], bp[w + 1])
        if subtile:
            want = want[(occ[want] >> g) & 1 == 1]
        assert np.array_equal(np.concatenate(walked), want)
        if count == 1:
            assert mine[0, 5] == -1 and (w, g) not in cut
        else:
            assert np.all(mine[:, 5] == mine[0, 5]) and cut[(w, g)] == (mine[0, 5], count)
            used_slots += [mine[0, 5] + k for k in range(count - 1)]
    assert sorted(used_slots) == list(range(slots))
    assert len(cut) == len(merges)
    if piece_work is not None:  # the dense hub blocks are cut by their work
        assert slots > walk_tasks(bp, piece_blocks, 2, occ)[2]


@pytest.mark.parametrize("subtile", [False, True])
def test_walk_tasks_in_a_window_chunk_equal_the_whole_plans(subtile):
    cfg = vt.PlanConfig(256, 32, cluster_cols=subtile)
    plan = vt.csr_preprocess(*csr_args(power_law()), cfg)

    def pieces(p, w_off=0, b_off=0):
        """(window, group, rank) -> (first block, end block, pieces)."""
        occ = occupancy(p).numpy() if subtile else None
        tasks = walk_tasks(p.block_ptr.numpy(), 3, 2, occ, block_work(p).numpy(), 300)[0]
        return {(w + w_off, g, r[4]): (r[2] + b_off, r[3] + b_off, len(rows))
                for (w, g), rows in by_group(tasks).items() for r in rows}

    whole, got, w0 = pieces(plan), {}, 0
    bp = plan.block_ptr.numpy()
    for sub in slice_plan_windows(plan, 3):
        got.update(pieces(sub, w0, bp[w0]))
        w0 += sub.num_windows
    assert got == whole


# (graph, config, d, subtile, piece size): the JAX kernel's geometries
# (block_w % 128 == 0, block_h % 32 == 0); the power-law graph's hub
# window splits into >= 8 pieces at piece sizes up to 2
EMULATION_CASES = [
    ("power_law", dict(block_h=128, block_w=128), 64, False, 2, None),
    ("power_law", dict(block_h=128, block_w=128), 64, False, 16, 600),
    ("power_law", dict(block_h=128, block_w=128), 130, False, 1, None),
    ("power_law", dict(block_h=96, block_w=128), 40, False, 3, 400),
    ("power_law", dict(block_h=512, block_w=128), 72, False, 2, None),
    ("power_law", dict(block_h=128, block_w=128, gather_segment=4), 40, False, 2, None),
    ("power_law", dict(block_h=128, block_w=128, cluster_cols=True), 64, True, 2, None),
    ("power_law", dict(block_h=512, block_w=128, cluster_cols=True), 96, True, 1, None),
    ("power_law", dict(block_h=512, block_w=128, cluster_cols=True), 96, True, 8, 500),
    ("power_law", dict(block_h=2048, block_w=128, block_unroll=4, cluster_cols=True), 48, True,
     3, None),
    ("rows_left_empty", dict(block_h=128, block_w=128), 24, False, 2, None),
    ("rows_left_empty", dict(block_h=128, block_w=128, cluster_cols=True), 24, True, 2, 300),
]


@pytest.mark.parametrize("graph,cfg,d,subtile,piece_blocks,piece_work", EMULATION_CASES)
def test_piece_split_matches_jax(graph, cfg, d, subtile, piece_blocks, piece_work):
    a = power_law()
    if graph == "rows_left_empty":  # windows 1.. of 128 rows keep no edge
        a = a.tolil()
        for r in range(128, N):
            a.rows[r], a.data[r] = [], []
        a = a.tocsr()
    jplan, tplan = both_plans(a, **cfg)
    occ = occupancy(tplan).numpy() if subtile else None
    work = None if piece_work is None else block_work(tplan).numpy()
    groups = -(-tplan.config.words_per_col // 4)
    tasks = walk_tasks(tplan.block_ptr.numpy(), piece_blocks, groups, occ, work, piece_work)[0]
    if graph == "power_law":  # the hub window's first group is cut into >= 8 pieces
        assert np.sum((tasks[:, 0] == 0) & (tasks[:, 1] == 0)) >= 8
    x = features(N, d, seed=d)
    out = emulate(tplan, torch.from_numpy(x), subtile, piece_blocks, piece_work)
    ref = np.asarray(jops.spmm_pallas(jplan, jnp.asarray(x), subtile=subtile))
    assert_close(out, ref)
    if subtile:  # the occupancy read from the bitmask when the plan has none
        no_occ = dataclasses.replace(tplan, occ=None)
        assert_close(emulate(no_occ, torch.from_numpy(x), True, piece_blocks, piece_work), ref)


def test_plan_walk_is_kept_outside_the_dataclass_fields():
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 32))
    walk = plan_walk(plan, "spmm_block")
    assert plan_walk(plan, "spmm_block") is walk
    assert "_walks" not in {f.name for f in dataclasses.fields(plan)}
    assert "_walks" not in dataclasses.replace(plan).__dict__
    assert "_walks" not in plan.to("cpu").__dict__
    tasks, merges, slots = walk_tasks(plan.block_ptr.numpy(), PIECE_BLOCKS["spmm_block"], 1,
                                      None, block_work(plan).numpy(), PIECE_WORK["spmm_block"])
    assert torch.equal(walk.tasks, torch.from_numpy(tasks))
    assert torch.equal(walk.merges, torch.from_numpy(merges))
    assert (walk.slots, walk.rows) == (slots, 128)


def test_plan_walk_of_k2_keeps_the_bitmask_occupancy():
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(256, 32, cluster_cols=True))
    no_occ = dataclasses.replace(plan, occ=None)
    walk = subtile_walk(no_occ)
    assert torch.equal(walk.occ, plan.occ)
    assert torch.equal(walk.tasks, subtile_walk(plan).tasks)


# K8 (the walk on int8 rows): (graph, config, d, piece size, work limit);
# the JAX kernel's geometries; d 130 gives int8 rows of 132 bytes
INT8_CASES = [
    ("power_law", dict(block_h=128, block_w=128), 64, 2, None),
    ("power_law", dict(block_h=128, block_w=128), 130, 16, 600),
    ("power_law", dict(block_h=512, block_w=128), 40, 3, 400),
    ("power_law", dict(block_h=128, block_w=128, gather_segment=4), 24, 2, None),
    ("rows_left_empty", dict(block_h=128, block_w=128), 24, 2, 300),
]


@pytest.mark.parametrize("graph,cfg,d,piece_blocks,piece_work", INT8_CASES)
def test_piece_split_matches_jax_int8(graph, cfg, d, piece_blocks, piece_work):
    a = power_law()
    if graph == "rows_left_empty":  # windows 1.. of 128 rows keep no edge
        a = a.tolil()
        for r in range(128, N):
            a.rows[r], a.data[r] = [], []
        a = a.tocsr()
    jplan, tplan = both_plans(a, **cfg)
    if graph == "power_law":  # the hub window's first group is cut into >= 8 pieces
        tasks = walk_tasks(tplan.block_ptr.numpy(), piece_blocks, groups_of(tplan), None,
                           None if piece_work is None else block_work(tplan).numpy(),
                           piece_work)[0]
        assert np.sum((tasks[:, 0] == 0) & (tasks[:, 1] == 0)) >= 8
    x = features(N, d, seed=d + 1)
    # the rows K8 sums: quantized per row, dequantized through bfloat16
    xq = dequantize_rows(*quantize_rows(torch.from_numpy(x)), torch.bfloat16).float()
    out = emulate(tplan, xq, False, piece_blocks, piece_work)
    assert_close(out, np.asarray(jops.spmm_pallas_int8(jplan, jnp.asarray(x))))
    assert_close(out, spmm_int8_reference(tplan, torch.from_numpy(x)))


@pytest.mark.parametrize("cfg", [dict(block_h=128, block_w=128),
                                 dict(block_h=2048, block_w=128, gather_segment=128,
                                      block_unroll=4)])
def test_plan_walk_of_k8_keeps_its_own_limits(cfg):
    """K8's work list takes PIECE_BLOCKS["spmm_int8"] and
    PIECE_WORK["spmm_int8"], is kept beside K1's on the same plan, and
    covers a block_h 2048 plan's 16 groups of 128 rows."""
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(**cfg))
    pb, pw = PIECE_BLOCKS["spmm_int8"], PIECE_WORK["spmm_int8"]
    assert 1 <= pb <= MAX_PIECE_BLOCKS and pw >= 1
    walk = plan_walk(plan, "spmm_int8")
    assert plan_walk(plan, "spmm_int8") is walk and walk.occ is None
    groups = groups_of(plan)
    work = block_work(plan).numpy()
    tasks, merges, slots = walk_tasks(plan.block_ptr.numpy(), pb, groups, None, work, pw)
    assert torch.equal(walk.tasks, torch.from_numpy(tasks))
    assert torch.equal(walk.merges, torch.from_numpy(merges))
    assert (walk.slots, walk.rows) == (slots, 32 * min(plan.config.words_per_col, 4))
    assert set(map(tuple, tasks[:, :2].tolist())) == {
        (w, g) for w in range(plan.num_windows) for g in range(groups)}
    for w, g, b0, b1, _, _ in tasks.tolist():
        assert b1 - b0 <= pb
        assert work[b0:b1, g].sum() <= pw + work[b0:b1, g].max(initial=0)
    saved = dict(PIECE_BLOCKS), dict(PIECE_WORK)
    try:
        PIECE_BLOCKS["spmm_int8"], PIECE_WORK["spmm_int8"] = 1, pw
        assert plan_walk(plan, "spmm_int8").tasks.shape[0] == max(plan.total_blocks, 1) * groups
        assert plan_walk(plan, "spmm_block") is not plan_walk(plan, "spmm_int8")
        PIECE_BLOCKS["spmm_int8"] = MAX_PIECE_BLOCKS + 1
        with pytest.raises(ValueError, match="PIECE_BLOCKS"):
            plan_walk(plan, "spmm_int8")
    finally:
        for current, default in zip((PIECE_BLOCKS, PIECE_WORK), saved):
            current.clear()
            current.update(default)
    assert plan_walk(plan, "spmm_int8") is walk


def test_plan_walk_of_k5_keeps_its_own_limit():
    """K5's work list takes PIECE_BLOCKS["spmm_dvalues"] and no work limit
    (a block's plane costs the same wherever its bits lie), is kept beside
    K4's on one plan and found again by a copy of the plan with another
    value plane; the hub window is cut into pieces of at most that many
    blocks (each piece's blocks written once: tests/test_torch_weighted.py)."""
    a = power_law()
    vals = np.random.default_rng(6).standard_normal(a.nnz).astype(np.float32)
    plan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(64, 128), values=vals)
    pb = PIECE_BLOCKS["spmm_dvalues"]
    assert pb >= 1 and PIECE_WORK["spmm_dvalues"] is None
    walk = plan_walk(plan, "spmm_dvalues")
    assert plan_walk(plan, "spmm_weighted") is not walk
    other = dataclasses.replace(plan, values=plan.values * 2)
    assert plan_walk(other, "spmm_dvalues") is walk
    tasks, _, _ = walk_tasks(plan.block_ptr.numpy(), pb, 1)
    assert torch.equal(walk.tasks, torch.from_numpy(tasks))
    assert np.all(tasks[:, 3] - tasks[:, 2] <= pb)
    bp = plan.block_ptr.numpy()
    assert np.sum(tasks[:, 0] == 0) == -(-int(bp[1]) // pb) > 1


# K4 (whole value tiles, a block limit alone): (graph, config, d, piece
# size, values); the JAX kernel's geometries (block_h % 8, block_w % 128);
# "off_mask": a random value in every slot of the plane, off the bitmask too
WEIGHTED_CASES = [
    ("power_law", dict(block_h=64, block_w=128), 40, 2, "edges"),
    ("power_law", dict(block_h=32, block_w=128), 8, 1, "edges"),
    ("power_law", dict(block_h=128, block_w=128), 130, 2, "edges"),
    ("power_law", dict(block_h=64, block_w=256), 16, 1, "edges"),
    ("power_law", dict(block_h=64, block_w=128), 40, 3, "off_mask"),
    ("rows_left_empty", dict(block_h=32, block_w=128), 24, 2, "edges"),
]


@pytest.mark.parametrize("graph,cfg,d,piece_blocks,values", WEIGHTED_CASES)
def test_piece_split_matches_jax_weighted(graph, cfg, d, piece_blocks, values):
    """K4's split: each piece of a group's blocks summed alone with K4's
    plain version, then added in piece order, against JAX's
    `spmm_pallas_weighted` in interpret mode; empty windows give zero rows."""
    a = power_law()
    h = cfg["block_h"]
    if graph == "rows_left_empty":  # windows 1.. keep no edge, and no block
        a = a.tolil()
        for r in range(h, N):
            a.rows[r], a.data[r] = [], []
        a = a.tocsr()
    rng = np.random.default_rng(d + piece_blocks)
    vals = rng.standard_normal(a.nnz).astype(np.float32)
    jplan = jfmt.csr_preprocess(a.indptr, a.indices, N, jfmt.PlanConfig(**cfg), backend="numpy",
                                values=vals)
    tplan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(**cfg), values=vals)
    if values == "off_mask":
        dense = rng.standard_normal(tuple(tplan.values.shape)).astype(np.float32)
        jplan = dataclasses.replace(jplan, values=jnp.asarray(dense))
        tplan = dataclasses.replace(tplan, values=torch.from_numpy(dense))
    tasks = walk_tasks(tplan.block_ptr.numpy(), piece_blocks, groups_of(tplan))[0]
    if graph == "power_law":  # the hub window's first group is cut into >= 8 pieces
        assert np.sum((tasks[:, 0] == 0) & (tasks[:, 1] == 0)) >= 8
    else:
        assert tplan.has_empty_windows and tplan.total_blocks == int(tplan.block_ptr[1])
    x = features(N, d, seed=d + 2)
    out = emulate(tplan, torch.from_numpy(x), False, piece_blocks)
    ref = np.asarray(jops.spmm_pallas_weighted(jplan, jnp.asarray(x)))
    assert_close(out, ref)
    if graph == "rows_left_empty":
        assert not out[h:].any()


def test_plan_walk_of_k4_keeps_its_own_limit():
    """K4's work list takes PIECE_BLOCKS["spmm_weighted"] and no work limit,
    is kept beside K1's and K8's on one plan, and is found again by a copy
    of the plan with another value plane (each GAT head makes one)."""
    vals = np.random.default_rng(5).standard_normal(power_law().nnz).astype(np.float32)
    a = power_law()
    plan = vt.csr_preprocess(a.indptr, a.indices, N, vt.PlanConfig(64, 128), values=vals)
    pb = PIECE_BLOCKS["spmm_weighted"]
    assert 1 <= pb <= MAX_PIECE_BLOCKS and PIECE_WORK["spmm_weighted"] is None
    walk = plan_walk(plan, "spmm_weighted")
    k1, k8 = plan_walk(plan, "spmm_block"), plan_walk(plan, "spmm_int8")
    assert len({id(walk), id(k1), id(k8)}) == 3
    assert plan_walk(plan, "spmm_weighted") is walk and plan_walk(plan, "spmm_block") is k1
    other = dataclasses.replace(plan, values=plan.values * 2)
    assert plan_walk(other, "spmm_weighted") is walk and plan_walk(other, "spmm_int8") is k8
    moved = dataclasses.replace(plan, block_ptr=plan.block_ptr.clone())
    assert plan_walk(moved, "spmm_weighted") is not walk
    tasks, merges, slots = walk_tasks(plan.block_ptr.numpy(), pb, 1)
    assert torch.equal(walk.tasks, torch.from_numpy(tasks))
    assert torch.equal(walk.merges, torch.from_numpy(merges))
    assert (walk.slots, walk.rows, walk.occ) == (slots, 64, None)
    assert np.all(tasks[:, 3] - tasks[:, 2] <= pb)
    assert walk.merges.shape[0] > 0  # the hub windows are cut
    saved = PIECE_BLOCKS["spmm_weighted"]
    try:
        PIECE_BLOCKS["spmm_weighted"] = 1
        assert plan_walk(plan, "spmm_weighted").tasks.shape[0] == plan.total_blocks + int(
            (np.diff(plan.block_ptr.numpy()) == 0).sum())
    finally:
        PIECE_BLOCKS["spmm_weighted"] = saved
    assert plan_walk(plan, "spmm_weighted") is walk


# K3 (the coverage-fused SpMM): the work list in slabs of `group_words`
# words, 8 (256 rows) on windows taller than 128 rows
FUSED_CONFIGS = [dict(block_h=128, block_w=128, gather_segment=8),
                 dict(block_h=512, block_w=128, gather_segment=8),
                 dict(block_h=2048, block_w=128, gather_segment=128, block_unroll=4),
                 dict(block_h=96, block_w=256, gather_segment=32),
                 dict(block_h=128, block_w=384, gather_segment=48)]


def fused_walk(plan, piece_blocks, piece_work=None):
    """plan_walk(plan, "spmm_fused") at the given limits (restored after)."""
    saved = PIECE_BLOCKS["spmm_fused"], PIECE_WORK["spmm_fused"]
    try:
        PIECE_BLOCKS["spmm_fused"], PIECE_WORK["spmm_fused"] = piece_blocks, piece_work
        return plan_walk(plan, "spmm_fused")
    finally:
        PIECE_BLOCKS["spmm_fused"], PIECE_WORK["spmm_fused"] = saved


@pytest.mark.parametrize("piece_blocks", [1, 3, 16])
@pytest.mark.parametrize("cfg", FUSED_CONFIGS)
def test_fused_pieces_cover_each_slab_once_in_order(cfg, piece_blocks):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(**cfg))
    words = plan.config.words_per_col
    walk = fused_walk(plan, piece_blocks)
    gw = walk.group_words
    assert gw == group_words("spmm_fused", words) == (8 if words > 4 else 4)
    assert walk.rows == 32 * min(words, gw)
    bp = plan.block_ptr.numpy()
    groups = by_group(walk.tasks.numpy())
    slabs = -(-words // gw)
    assert set(groups) == {(w, g) for w in range(plan.num_windows) for g in range(slabs)}
    for (w, g), rows in groups.items():
        mine = np.array(rows)
        assert np.array_equal(mine[:, 4], np.arange(len(mine)))  # ranks in order
        assert mine[0, 2] == bp[w] and mine[-1, 3] == bp[w + 1]
        assert np.array_equal(mine[1:, 2], mine[:-1, 3])  # consecutive, no gap or overlap
        assert np.all(mine[:, 3] - mine[:, 2] <= piece_blocks)
        if bp[w + 1] > bp[w]:
            assert np.all(mine[:, 3] > mine[:, 2])


@pytest.mark.parametrize("limits", [(2, None), (256, 300)])
def test_fused_hub_window_splits_into_many_pieces(limits):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 128, gather_segment=8))
    tasks = fused_walk(plan, *limits).tasks.numpy()
    per_window = np.bincount(tasks[:, 0])
    assert per_window[0] >= 8 and per_window.argmax() == 0  # window 0 holds the hubs


@pytest.mark.parametrize("cfg", FUSED_CONFIGS[:3])
def test_fused_empty_windows_get_one_empty_piece(cfg):
    h = cfg["block_h"]
    n = 80 * h  # window 0 alone keeps edges: the empty windows dominate, left without blocks
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, h, 4000), rng.integers(0, n, 4000)
    a = sp.csr_matrix((np.ones(4000, np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    plan = vt.csr_preprocess(*csr_args(a), vt.PlanConfig(**cfg))
    bp = plan.block_ptr.numpy()
    empty = [w for w in range(plan.num_windows) if bp[w + 1] == bp[w]]
    assert plan.has_empty_windows and len(empty) == plan.num_windows - 1
    walk = fused_walk(plan, 2)
    groups = by_group(walk.tasks.numpy())
    slabs = -(-plan.config.words_per_col // walk.group_words)
    for w in empty:
        for g in range(slabs):
            (row,) = groups[(w, g)]
            assert row[2] == row[3] == bp[w] and row[4:] == [0, -1]
    none = vt.csr_preprocess(np.zeros(N + 1, np.int64), np.zeros(0, np.int64), N,
                             vt.PlanConfig(**cfg))
    walk = fused_walk(none, 2)
    assert none.total_blocks == 0 and walk.slots == 0 and walk.merges.shape == (0, 4)
    slabs = -(-none.config.words_per_col // walk.group_words)
    assert walk.tasks.shape[0] == none.num_windows * slabs
    assert np.all(walk.tasks[:, 2:4].numpy() == 0)


@pytest.mark.parametrize("num_chunks", [2, 3])
@pytest.mark.parametrize("cfg", FUSED_CONFIGS[1:3])
def test_fused_pieces_in_a_window_chunk_equal_the_whole_plans(cfg, num_chunks):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(**cfg))

    def pieces(p, w_off=0, b_off=0):
        """(window, slab, rank) -> (first block, end block, pieces)."""
        tasks = fused_walk(p, 3, 200).tasks.numpy()
        return {(w + w_off, g, r[4]): (r[2] + b_off, r[3] + b_off, len(rows))
                for (w, g), rows in by_group(tasks).items() for r in rows}

    whole, got, w0 = pieces(plan), {}, 0
    bp = plan.block_ptr.numpy()
    for sub in slice_plan_windows(plan, num_chunks):
        got.update(pieces(sub, w0, bp[w0]))
        w0 += sub.num_windows
    assert got == whole


# (graph, config, d, piece size, work limit): the JAX kernel's coverage
# geometries (gather_segment >= 8, block_w % 128 == 0, block_h % 32 == 0)
FUSED_CASES = [
    ("power_law", dict(block_h=128, block_w=128, gather_segment=8), 64, 2, None),
    ("power_law", dict(block_h=512, block_w=128, gather_segment=8), 40, 3, 300),
    ("power_law", dict(block_h=2048, block_w=128, gather_segment=128, block_unroll=4), 24, 2,
     None),
    ("power_law", dict(block_h=96, block_w=256, gather_segment=32), 130, 1, None),
    ("rows_left_empty", dict(block_h=256, block_w=128, gather_segment=16), 8, 2, 200),
    # runs that cross the 128-lane tiles the kernel stages
    ("power_law", dict(block_h=128, block_w=384, gather_segment=48), 128, 2, None),
    ("power_law", dict(block_h=256, block_w=384, gather_segment=24), 256, 3, 300),
]


@pytest.mark.parametrize("graph,cfg,d,piece_blocks,piece_work", FUSED_CASES)
def test_piece_split_matches_jax_fused(graph, cfg, d, piece_blocks, piece_work):
    """K3's split: each piece of a slab's blocks summed alone with K3's plain
    version, then added in piece order, against JAX's `spmm_pallas_fused`
    in interpret mode."""
    a = power_law()
    if graph == "rows_left_empty":  # windows 1.. keep no edge
        a = a.tolil()
        for r in range(cfg["block_h"], N):
            a.rows[r], a.data[r] = [], []
        a = a.tocsr()
    jplan, tplan = both_plans(a, **cfg)
    gw = group_words("spmm_fused", tplan.config.words_per_col)
    if graph == "power_law":  # the hub window's first slab is cut into >= 4 pieces
        tasks = fused_walk(tplan, piece_blocks, piece_work).tasks.numpy()
        assert np.sum((tasks[:, 0] == 0) & (tasks[:, 1] == 0)) >= 4
    x = features(N, d, seed=d + 3)
    out = emulate(tplan, torch.from_numpy(x), False, piece_blocks, piece_work, gw=gw,
                  plain=spmm_fused_reference)
    assert_close(out, np.asarray(jops.spmm_pallas_fused(jplan, jnp.asarray(x))))
    if graph == "rows_left_empty":
        assert not out[cfg["block_h"]:].any()


@pytest.mark.parametrize("block_w,seg", [(128, 8), (128, 128), (256, 256), (384, 12), (384, 24),
                                         (384, 48), (384, 96), (384, 192), (384, 384),
                                         (1152, 9)])
def test_fused_boxes_stay_within_a_run_and_a_tile(block_w, seg):
    """K3's bulk copies stage each 128-lane tile in boxes of `box_rows(seg)`
    rows at the multiples of it: the boxes cover each tile once, none
    crosses a run's edge, and the kernel takes them only where a box is
    8 rows or more."""
    box = box_rows(seg)
    assert 128 % box == 0 and seg % box == 0
    for lane0 in range(0, block_w, 128):
        starts = np.arange(lane0, lane0 + 128, box)
        assert np.array_equal(np.repeat(starts, box), np.arange(lane0, lane0 + 128) // box * box)
        assert np.all(starts // seg == (starts + box - 1) // seg)
    assert (box >= 8) == (seg % 8 == 0)


# --- K9-K15's work lists (ops/attention.py:attention_walk) -------------------

def attn_walk(plan, name, piece_blocks, piece_work):
    """attention_walk(plan, name) at the given limits (restored after)."""
    saved = PIECE_BLOCKS[name], PIECE_WORK[name]
    try:
        PIECE_BLOCKS[name], PIECE_WORK[name] = piece_blocks, piece_work
        return attention_walk(plan, name)
    finally:
        PIECE_BLOCKS[name], PIECE_WORK[name] = saved


@pytest.mark.parametrize("name", ["spmm_attention", "attention_bwd", "spmm_attention_mh",
                                  "attention_mh_dq", "attention_mh_dkv"])
@pytest.mark.parametrize("limits", [(1, None), (3, 200), (16, 1024)])
@pytest.mark.parametrize("cfg", [dict(block_h=128, block_w=32), dict(block_h=256, block_w=128),
                                 dict(block_h=48, block_w=128)])
def test_attention_pieces_cover_each_window_once_in_order(cfg, limits, name):
    """K9's, K10's, K13's, K14's and K15's pieces cover every block of every
    128-row group once, in order; K9 and K13 give every piece of a cut
    group a share slot of its own (the merge's first slot and count), K10,
    K14 and K15 its pieces 1.. (the walk's)."""
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(**cfg))
    walk = attn_walk(plan, name, *limits)
    bp = plan.block_ptr.numpy()
    groups = by_group(walk.tasks.numpy())
    assert set(groups) == {(w, g) for w in range(plan.num_windows) for g in range(groups_of(plan))}
    merges = {(m[0], m[1]): (m[2], m[3]) for m in walk.merges.tolist()}
    slots = []
    for (w, g), rows in groups.items():
        mine = np.array(rows)
        assert np.array_equal(mine[:, 4], np.arange(len(mine)))
        assert mine[0, 2] == bp[w] and mine[-1, 3] == bp[w + 1]
        assert np.array_equal(mine[1:, 2], mine[:-1, 3])
        assert np.all(mine[:, 3] - mine[:, 2] <= limits[0])
        if len(mine) == 1:
            assert mine[0, 5] == -1 and (w, g) not in merges
            continue
        first, count = merges[(w, g)]
        assert count == len(mine) and np.all(mine[:, 5] == first)
        mine_slots = first + mine[:, 4] if name in SHARE_KERNELS else first + mine[1:, 4] - 1
        slots.extend(mine_slots.tolist())
    assert sorted(slots) == list(range(walk.slots))  # every slot once


@pytest.mark.parametrize("name", ["spmm_attention", "spmm_attention_mh", "attention_mh_dq",
                                  "attention_mh_dkv"])
@pytest.mark.parametrize("limits", [(2, None), (16, 300)])
def test_attention_hub_window_splits_into_many_pieces(limits, name):
    """The hub window of a power-law graph becomes many pieces of bounded
    work: none holds more than the work limit and one block's work."""
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 128, block_unroll=4))
    walk = attn_walk(plan, name, *limits)
    per_window = np.bincount(walk.tasks[:, 0].numpy())
    assert per_window[0] >= 8 and per_window.argmax() == 0
    if limits[1] is not None:
        work = block_work(plan)[:, 0]
        tasks = walk.tasks.long()
        cum = torch.cat([work.new_zeros(1), work.cumsum(0)])
        per_task = cum[tasks[:, 3]] - cum[tasks[:, 2]]
        assert int(per_task.max()) <= limits[1] + int(work.max())


@pytest.mark.parametrize("name", ["spmm_attention", "attention_bwd", "spmm_attention_mh",
                                  "attention_mh_dq", "attention_mh_dkv"])
def test_attention_empty_windows_get_one_empty_piece(name):
    """A window without blocks, and every window of a plan without blocks,
    gets one empty piece, which writes its rows."""
    h = 128
    n = 80 * h  # window 0 alone keeps edges: the empty windows are left without blocks
    rng = np.random.default_rng(8)
    rows, cols = rng.integers(0, h, 4000), rng.integers(0, n, 4000)
    a = sp.csr_matrix((np.ones(4000, np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    plan = vt.csr_preprocess(*csr_args(a), vt.PlanConfig(h, 128))
    bp = plan.block_ptr.numpy()
    empty = [w for w in range(plan.num_windows) if bp[w + 1] == bp[w]]
    assert plan.has_empty_windows and len(empty) == plan.num_windows - 1
    groups = by_group(attn_walk(plan, name, 2, 100).tasks.numpy())
    for w in empty:
        (row,) = groups[(w, 0)]
        assert row[2] == row[3] == bp[w] and row[4:] == [0, -1]
    none = vt.csr_preprocess(np.zeros(N + 1, np.int64), np.zeros(0, np.int64), N,
                             vt.PlanConfig(256, 128))
    walk = attn_walk(none, name, 2, 100)
    assert none.total_blocks == 0 and walk.slots == 0 and walk.merges.shape == (0, 4)
    assert walk.tasks.shape[0] == none.num_windows * groups_of(none)
    assert np.all(walk.tasks[:, 2:4].numpy() == 0) and np.all(walk.tasks[:, 5].numpy() == -1)


@pytest.mark.parametrize("name", ["spmm_attention", "spmm_attention_mh", "attention_mh_dq",
                                  "attention_mh_dkv"])
@pytest.mark.parametrize("num_chunks", [2, 3])
def test_attention_pieces_in_a_window_chunk_equal_the_whole_plans(num_chunks, name):
    plan = vt.csr_preprocess(*csr_args(power_law()), vt.PlanConfig(128, 128, block_unroll=4))

    def pieces(p, w_off=0, b_off=0):
        """(window, group, rank) -> (first block, end block, pieces)."""
        tasks = attn_walk(p, name, 3, 200).tasks.numpy()
        return {(w + w_off, g, r[4]): (r[2] + b_off, r[3] + b_off, len(rows))
                for (w, g), rows in by_group(tasks).items() for r in rows}

    whole, got, w0 = pieces(plan), {}, 0
    bp = plan.block_ptr.numpy()
    for sub in slice_plan_windows(plan, num_chunks):
        got.update(pieces(sub, w0, bp[w0]))
        w0 += sub.num_windows
    assert got == whole

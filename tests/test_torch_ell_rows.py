"""K6's row order (voltrix_spmm_tpu_torch/ops/ell.py: ell_row_order,
plan_rows) on the CPU, against the JAX package.

K6 sums each output row over the plan's non-padding lanes grouped by
destination row, in lane order, each row cut into pieces of at most
PIECE_LANES lanes whose sums are added in piece order. The kernel runs only
on the card (chip_smoke.py holds it to its plain version and runs it twice
for the same bits); here the row order's cover of the lanes, its pieces on
window chunks, and a plain emulation of the summation order (row pieces,
then the merge in piece order) against the JAX package's `spmm_ell`, to the
tolerance of tests/test_torch_ell.py (rtol 1e-5, atol 1e-4: float32 sums
in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voltrix_spmm_tpu.format as jfmt
import voltrix_spmm_tpu.ops as jops
import voltrix_spmm_tpu_torch as vt
import voltrix_spmm_tpu_torch.format as tfmt
from voltrix_spmm_tpu_torch import utils
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.ops import ell
from voltrix_spmm_tpu_torch.ops.ell import ell_row_order, plan_rows

TOL = dict(rtol=1e-5, atol=1e-4)
N = 3000


def power_law():
    """A symmetrised Chung-Lu graph with random edge values: its hub rows
    hold hundreds of edges."""
    a = symmetrize(chung_lu_csr(N, 30000, seed=5)).astype(np.float32)
    a.data[:] = np.random.default_rng(5).standard_normal(a.nnz).astype(np.float32)
    return a


def both_plans(a, pad_vals=False, **cfg):
    """The JAX and the port's EllPlan of `a`; with pad_vals, the padding
    lanes carry non-zero values in both."""
    n = a.shape[0]
    jplan = jfmt.csr_preprocess_ell(a.indptr, a.indices, n, jfmt.PlanConfig(**cfg),
                                    values=a.data)
    tplan = vt.csr_preprocess_ell(a.indptr, a.indices, n, vt.PlanConfig(**cfg), values=a.data)
    if pad_vals:
        vals = tplan.vals.numpy().copy()
        pad = tplan.erow.numpy() < 0
        assert pad.any()
        vals[pad] = np.random.default_rng(6).standard_normal(int(pad.sum())) + 3.0
        jplan = dataclasses.replace(jplan, vals=vals)
        tplan = dataclasses.replace(tplan, vals=torch.from_numpy(vals))
    return jplan, tplan


def dest_rows(plan):
    """int64 (total_blocks * block_w,) destination row of every lane."""
    k, h = plan.config.block_w, plan.config.block_h
    return plan.window_of_block.long().repeat_interleave(k) * h + plan.erow.reshape(-1).long()


def pieces_by_row(plan, rows, row_off=0, lane_off=0):
    """row -> [(source rows, lanes) of each piece, in piece order]."""
    items = rows.items.long().tolist()
    out = {}
    for r, b, e, _ in items:
        piece = (tuple(rows.src[b:e].tolist()),
                 tuple(x + lane_off for x in rows.lane[b:e].tolist()))
        out.setdefault(r + row_off, []).append(piece)
    return out


def emulate(plan, x, piece_lanes):
    """K6's summation order in plain torch: each piece summed over its
    lanes, written to out (piece 0) or its workspace row, then each cut
    row's pieces added to out in piece order."""
    rows = ell_row_order(plan, piece_lanes)
    items = rows.items.long()
    vals = plan.vals.reshape(-1)
    contrib = x[rows.src.long()] * vals[rows.lane.long()][:, None]
    piece = torch.repeat_interleave(torch.arange(len(items)), items[:, 2] - items[:, 1])
    sums = torch.zeros(len(items), x.shape[1]).index_add_(0, piece, contrib)
    out = torch.zeros(plan.num_nodes, x.shape[1])
    first = items[:, 3] < 0
    out[items[first, 0]] = sums[first]
    ws = torch.zeros(rows.slots, x.shape[1])
    ws[items[~first, 3]] = sums[~first]
    merges = rows.merges.long()
    for k in range(int(merges[:, 2].max()) - 1 if len(merges) else 0):
        cut = merges[:, 2] > k + 1
        out[merges[cut, 0]] += ws[merges[cut, 1] + k]
    return out


@pytest.mark.parametrize("piece_lanes", [1, 3, 16, 128])
@pytest.mark.parametrize("cfg", [dict(block_h=128, block_w=128),
                                 dict(block_h=32, block_w=128, block_unroll=4),
                                 dict(block_h=64, block_w=256)])
def test_row_order_covers_every_real_lane_once(cfg, piece_lanes):
    _, plan = both_plans(power_law(), **cfg)
    rows = ell_row_order(plan, piece_lanes)
    dest = dest_rows(plan)
    real = torch.nonzero((plan.erow.reshape(-1) >= 0) & (dest < plan.num_nodes)).squeeze(1)
    lane = rows.lane.long()
    # each real lane exactly once, no padding lane
    assert torch.equal(torch.sort(lane).values, real)
    assert bool((plan.erow.reshape(-1)[lane] >= 0).all())
    # grouped by row, in lane order within a row; source rows beside them
    r = dest[lane]
    assert bool((r[1:] >= r[:-1]).all())
    same = r[1:] == r[:-1]
    assert bool((lane[1:][same] > lane[:-1][same]).all())
    assert torch.equal(rows.src.long(), plan.hind.reshape(-1)[lane].long())
    # items: consecutive ranges covering the order, each within one row,
    # every row at least one, none longer than piece_lanes
    items = rows.items.long()
    assert int(items[0, 1]) == 0 and int(items[-1, 2]) == len(lane)
    assert torch.equal(items[1:, 1], items[:-1, 2])
    assert bool(((items[:, 2] - items[:, 1]) <= piece_lanes).all())
    assert torch.equal(torch.unique(items[:, 0]), torch.arange(plan.num_nodes))
    for (row, b, e, _) in items[items[:, 2] > items[:, 1]].tolist():
        assert bool((r[b:e] == row).all())
    # workspace rows: pieces 1.. of each cut row, each slot used once
    slots = items[items[:, 3] >= 0, 3]
    assert torch.equal(torch.sort(slots).values, torch.arange(rows.slots))
    counts = torch.bincount(items[:, 0], minlength=plan.num_nodes)
    merges = rows.merges.long()
    assert torch.equal(merges[:, 0], torch.nonzero(counts > 1).squeeze(1))
    assert torch.equal(merges[:, 2], counts[counts > 1])


def test_row_order_of_padding_and_empty_rows():
    """Padding blocks, padded empty windows and rows past num_nodes add no
    lane; every row still gets one (empty) piece."""
    a = power_law().tolil()
    for r in range(128, 512):
        a.rows[r], a.data[r] = [], []
    _, plan = both_plans(a.tocsr(), block_h=128, block_w=128, block_unroll=4)
    rows = ell_row_order(plan, 8)
    assert rows.lane.shape == (plan.num_edges,)
    items = rows.items.long()
    empty = items[(items[:, 0] >= 128) & (items[:, 0] < 512)]
    assert torch.equal(empty[:, 0], torch.arange(128, 512))
    assert bool((empty[:, 1] == empty[:, 2]).all()) and bool((empty[:, 3] == -1).all())
    none = vt.csr_preprocess_ell(np.zeros(12801, np.int64), np.zeros(0, np.int64), 12800)
    assert none.total_blocks == 0
    rows = ell_row_order(none, 8)
    assert rows.items.shape == (12800, 4) and rows.slots == 0 and rows.merges.shape == (0, 3)


@pytest.mark.parametrize("num_chunks", [2, 3, 5])
def test_row_order_on_window_chunks_equals_the_whole_plans(num_chunks):
    _, plan = both_plans(power_law(), block_h=128, block_w=128, block_unroll=4)
    whole = pieces_by_row(plan, ell_row_order(plan, 16))
    got, w0 = {}, 0
    bp = plan.block_ptr.numpy()
    for sub in tfmt.slice_ell_windows(plan, num_chunks):
        got.update(pieces_by_row(sub, ell_row_order(sub, 16), row_off=w0 * 128,
                                 lane_off=int(bp[w0]) * 128))
        w0 += sub.num_windows
    assert w0 == plan.num_windows
    assert got == whole


# (config, d, piece lanes, padding values): the power-law graph's hub row is
# cut into >= 8 pieces at piece sizes up to 16
EMULATION_CASES = [
    (dict(block_h=128, block_w=128), 8, 16, True),
    (dict(block_h=128, block_w=128, block_unroll=4), 40, 4, True),
    (dict(block_h=128, block_w=128), 64, 1, False),
    (dict(block_h=32, block_w=128, block_unroll=4), 24, 7, True),
    (dict(block_h=64, block_w=256), 40, 128, True),
]


@pytest.mark.parametrize("cfg,d,piece_lanes,pad_vals", EMULATION_CASES)
def test_row_pieces_match_jax(cfg, d, piece_lanes, pad_vals):
    jplan, tplan = both_plans(power_law(), pad_vals=pad_vals, **cfg)
    rows = ell_row_order(tplan, piece_lanes)
    assert int(rows.merges[:, 2].max()) >= (8 if piece_lanes <= 16 else 2)
    x = np.random.default_rng(d).standard_normal((N, d)).astype(np.float32)
    out = emulate(tplan, torch.from_numpy(x), piece_lanes)
    ref = np.asarray(jops.spmm_ell(jplan, jnp.asarray(x)))
    assert vt.calc_diff(out.numpy(), ref) < 1e-6
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), vt.spmm_ell(tplan, torch.from_numpy(x)).numpy(),
                               **TOL)


def test_plan_rows_is_kept_beside_the_lanes():
    """One row order per plan's lanes: the copies that replace a plan's
    values share it (so does `.to` to the device it is on, which copies
    nothing); new lanes or a new piece limit get their own; it goes with the
    erow tensor."""
    _, plan = both_plans(power_law(), block_h=128, block_w=128)
    rows = plan_rows(plan)
    assert rows.piece_lanes == ell.PIECE_LANES
    assert plan_rows(dataclasses.replace(plan, vals=plan.vals * 2)) is rows
    assert plan_rows(plan.to("cpu")) is rows
    assert plan_rows(dataclasses.replace(plan, erow=plan.erow.clone())) is not rows
    default = ell.PIECE_LANES
    try:
        ell.PIECE_LANES = 5
        assert plan_rows(plan).piece_lanes == 5
    finally:
        ell.PIECE_LANES = default
    assert plan_rows(plan).piece_lanes == default
    key = id(plan.erow)
    assert key in utils._KEPT
    del plan, rows
    assert key not in utils._KEPT

"""compute_dtype=torch.bfloat16 in the fused attention's backward (kernels
K10, K11, K12, K14 and K15) against the JAX package on the CPU.

The same numpy inputs go through `spmm_attention_ad` (with plan_t: K11 and
K12; without: K10) and `spmm_attention_mh_ad` (K14 and K15, float32 and
bf16 planes) of both packages under compute_dtype bf16; the JAX side takes
`jax.grad` with its Pallas kernels in interpret mode, the port runs the
plain versions (ops/_attn_core.py:_dq_plain, _dkv_plain;
ops/attention.py:attention_bwd_reference), which round where JAX rounds: q,
k, v and dO to bf16 before every product, p before dv's product, draw =
bf16(ds) before dq's and dk's, scores and dP summed in column order. On
bf16 planes JAX's K15 reads lse and D as bf16 hi + lo pairs, and the port's
K15 takes them so under the flag (`_hi_lo`).

The tolerance is the port's GRAD_TOL, rtol 1e-4 and atol 1e-5, on every
plane. A case may miss it only through edges whose draw (or p) lands on the
neighbouring bf16 value: JAX sums the scores, dP and D in another order, so
its value before rounding may lie on the other side of a rounding midpoint.
`assert_grads` then finds, for each row that misses, the edges whose value
lies within one float32 ulp of each of its inputs (the score, lse, dP and
D; on bf16 planes one ulp of lse or D may flip K15's hi or lo, a bf16 step
of lo) of that midpoint, shows that taking the neighbouring bf16 value on
some of them brings the row within GRAD_TOL, counts them, and holds the
case to max error over max magnitude < 1e-3. A case without such an
explanation fails. The compute-float32 gradients miss GRAD_TOL by at least 10x (the
rounding points matter), and the kernels' pieces, emulated, match the plain
versions.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voltrix_spmm_tpu.ops import spmm_attention_ad as jax_ad
from voltrix_spmm_tpu.ops import spmm_attention_mh_ad as jax_mh_ad
from voltrix_spmm_tpu_torch.ops import (
    attention_bwd_reference,
    attention_mh_dkv_reference,
    attention_mh_dq_reference,
    spmm_attention_ad,
    spmm_attention_mh_ad,
    spmm_attention_mh_reference,
)
from voltrix_spmm_tpu_torch.ops._attn_core import _act, _bf16, _chain, _ds, _edges, _hi_lo

from test_torch_attention import plans, random_graph
from test_torch_attention_compute import GEOMETRIES
from test_torch_attention_mh import bwd_walk, emulate_pieces, power_law

TOL = dict(rtol=1e-4, atol=1e-5)  # the port's GRAD_TOL
BF16 = torch.bfloat16
OTHER = {"h32": "h128u2", "h128u2": "h32"}  # the directed graph's plan_t geometry


@pytest.fixture(scope="module")
def graphs():
    return make_graphs()


def make_graphs():
    """A symmetric graph and a directed one (its plan_t of the other
    geometry), each with 40 edgeless rows at the tail; both packages'
    plans; q, k, v and dO for one head (dk 24, dv 40) and four (dk 8, dv
    16); JAX's gradients, each once."""
    out = {"jax": {}}
    for kind, seed in (("sym", 1), ("directed", 3)):
        a = random_graph(seed=seed, empty_tail=40, symmetric=kind == "sym")
        for geo, cfg in GEOMETRIES.items():
            cfg_t = cfg if kind == "sym" else GEOMETRIES[OTHER[geo]]
            out[kind, geo] = plans(a, cfg, cfg_t)
        out[kind] = a
    n = out["sym"].shape[0]
    rng = np.random.default_rng(2)
    out["one"] = tuple(rng.standard_normal((n, d)).astype(np.float32) for d in (24, 24, 40, 40))
    out["four"] = tuple(rng.standard_normal((4, n, d)).astype(np.float32)
                        for d in (8, 8, 16, 16))
    return out


def jax_grads(graphs, key, fn):
    """JAX's (dq, dk, dv) for `key`, computed once for the module."""
    if key not in graphs["jax"]:
        graphs["jax"][key] = [np.asarray(x) for x in fn()]
    return graphs["jax"][key]


def jax_one(graphs, kind, geo, slope, with_t, compute=jnp.bfloat16):
    jp, jpt = graphs[kind, geo][0]
    q, k, v, w = graphs["one"]

    def loss(*x):
        out = jax_ad(jp, *x, plan_t=jpt if with_t else None, negative_slope=slope,
                     compute_dtype=compute)
        return jnp.sum(out * w)

    return jax_grads(graphs, ("one", kind, geo, slope, with_t, compute), lambda: jax.grad(
        loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v))))


def jax_mh(graphs, kind, geo, slope, heads, plane):
    jp, jpt = graphs[kind, geo][0]
    q, k, v, w = (x[:heads] for x in graphs["four"])

    def loss(*x):
        out = jax_mh_ad(jp, *x, plan_t=jpt, negative_slope=slope, compute_dtype=jnp.bfloat16,
                        plane_dtype=jnp.bfloat16 if plane == "bf16" else None)
        return jnp.sum(out * w)

    return jax_grads(graphs, ("four", kind, geo, slope, heads, plane), lambda: jax.grad(
        loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v))))


def port_grads(fn, q, k, v, w):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fn(*leaves) * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in leaves]


# --- the flips: edges whose rounding lands on the neighbouring bf16 value ----

def ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def bf16_sides(x: torch.Tensor):
    """(x rounded to bf16, the bf16 value on the other side of x, x's
    distance in float32 ulps from the midpoint between the two)."""
    bits = x.contiguous().view(torch.int32)
    trunc = bits & -65536
    rounded = _bf16(x)
    other = torch.where(rounded.view(torch.int32) == trunc, trunc + 65536, trunc)
    return rounded, other.view(torch.float32), ((bits & 65535) - 32768).abs()


def near_midpoint(x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """x lies within eps of a midpoint between two neighbouring bf16 values."""
    return bf16_sides(x)[2].double() * ulp(x).double() <= eps


def stat_eps(x: torch.Tensor, plane: str) -> torch.Tensor:
    """What one float32 ulp of a statistic (lse or D) moves the value K15
    takes: the ulp itself, and on bf16 planes (hi + lo, `_hi_lo`) a whole
    bf16 step of lo where x, or x - hi, lies within that ulp of a bf16
    rounding midpoint, so that hi or lo rounds the other way."""
    eps = ulp(x).double()
    if plane != "bf16":
        return eps
    rest = x - _bf16(x)
    rounded, other, _ = bf16_sides(rest)
    flips = near_midpoint(x, eps) | near_midpoint(rest, eps)
    return eps + flips * (other - rounded).abs().double()


def edge_terms(plan, q, k, v, w, scale, slope, plane):
    """Each edge's terms as the port's plain versions take them, on (H, n,
    d) stacks: rows r and columns c, and for the dq side (float32 stats)
    and the dk/dv side (JAX's hi + lo stats on bf16 planes) the coefficient
    before rounding (ds, and p for dv), with `eps`, what one float32 ulp of
    each of its inputs (the score, lse, dP and D; `stat_eps`) and of itself
    moves it."""
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    out, lse = spmm_attention_mh_reference(plan, tq, tk, tv, negative_slope=slope,
                                           return_stats=True, compute_dtype=BF16)
    d_row = (tw * out).sum(-1)
    rows, cols, _ = _edges(plan)
    qb, kb, vb, wb = (_bf16(t) for t in (tq, tk, tv, tw))
    raw = _chain(qb[:, rows], kb[:, cols])
    dp = _chain(wb[:, rows], vb[:, cols])
    s = _act(raw, scale, slope)
    grad = torch.where(raw > 0, 1.0, slope) if slope != 1.0 else torch.ones_like(raw)
    sides = {}
    for side, pl in (("q", "f32"), ("kv", plane)):
        stats = (lse, d_row) if pl == "f32" else (_hi_lo(lse), _hi_lo(d_row))
        le, de = (t[:, rows] for t in stats)
        eps_l, eps_d = (stat_eps(t, pl)[:, rows] for t in (lse, d_row))
        p = torch.exp(s - le)
        ds = _ds(p, dp, de, raw, scale, slope)
        eps_ds = ((p * grad * scale).abs().double() * (ulp(dp).double() + eps_d)
                  + ds.abs().double() * (ulp(s).double() + eps_l) + ulp(ds).double())
        eps_p = p.double() * (ulp(s).double() + eps_l) + ulp(p).double()
        sides[side] = dict(ds=ds, eps_ds=eps_ds, p=p, eps_p=eps_p)
    return dict(rows=rows, cols=cols, qb=qb, kb=kb, wb=wb, sides=sides)


def explain(got, want, terms, what):
    """Rows of `got` (H, n, d) that miss GRAD_TOL against `want`, each
    explained by flips: the edges of the row whose coefficient lies within
    its eps of a bf16 rounding midpoint, some of which, taken at the
    neighbouring bf16 value, bring the row within GRAD_TOL. Returns the
    number of flips; fails on a row without such an explanation."""
    rows, cols = terms["rows"], terms["cols"]
    side = terms["sides"]["q" if what == "dq" else "kv"]
    x, eps = (side["p"], side["eps_p"]) if what == "dv" else (side["ds"], side["eps_ds"])
    rounded, other, _ = bf16_sides(x)
    near = near_midpoint(x, eps)
    own, vec = {"dq": (rows, terms["kb"][:, cols]), "dk": (cols, terms["qb"][:, rows]),
                "dv": (cols, terms["wb"][:, rows])}[what]
    tol = TOL["atol"] + TOL["rtol"] * np.abs(want)
    flips = 0
    for h, r in sorted({(int(h), int(r)) for h, r, _ in
                        zip(*np.nonzero(np.abs(got - want) > tol))}):
        cand = torch.nonzero((own == r) & near[h]).squeeze(1).tolist()
        assert len(cand) <= 8, f"{what}[{h}, {r}]: {len(cand)} edges near a midpoint"
        res = want[h, r] - got[h, r]
        best = None
        for m in range(1, len(cand) + 1):
            for sub in itertools.combinations(cand, m):
                shift = sum(((other[h, e] - rounded[h, e]) * vec[h, e]).numpy() for e in sub)
                if (np.abs(res - shift) <= tol[h, r]).all():
                    best = sub
                    break
            if best:
                break
        assert best, (f"{what}[{h}, {r}] misses GRAD_TOL by {np.abs(res).max():.3e}, and no "
                      f"flip of its {len(cand)} edges near a bf16 midpoint explains it")
        flips += len(best)
    return flips


def assert_grads(got, want, terms, what="qkv"):
    """GRAD_TOL, or misses explained by flips (`explain`) and max error over
    max magnitude < 1e-3; returns the flips counted per gradient."""
    flips = {}
    for x, ref, name in zip(got, want, what):
        x, ref = np.asarray(x, np.float32), np.asarray(ref, np.float32)
        x3, ref3 = (t.reshape((-1, *t.shape[-2:])) for t in (x, ref))
        if np.allclose(x, ref, **TOL):
            continue
        flips[name] = explain(x3, ref3, terms, f"d{name}")
        err = np.abs(x - ref).max() / np.abs(ref).max()
        assert flips[name] > 0 and err < 1e-3, f"d{name}: {err:.3e}, {flips[name]} flips"
    return flips


# --- the gradients against jax.grad -------------------------------------------------

@pytest.mark.parametrize("with_t", [True, False], ids=["plan_t", "k10"])
@pytest.mark.parametrize("slope", [1.0, 0.2], ids=["ident", "leaky"])
@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("kind", ["sym", "directed"])
def test_spmm_attention_ad_compute_bf16_matches_jax_grad(graphs, kind, geo, slope, with_t):
    """spmm_attention_ad under compute_dtype bf16: with plan_t K11's and
    K12's plain versions, without it K10's (its lane planes summed in the
    card path's source order), against jax.grad of JAX's op under the flag;
    the edgeless rows' gradients exactly 0."""
    jp, tp = graphs[kind, geo]
    q, k, v, w = graphs["one"]
    want = jax_one(graphs, kind, geo, slope, with_t)
    got = port_grads(lambda *x: spmm_attention_ad(tp[0], *x, plan_t=tp[1] if with_t else None,
                                                  negative_slope=slope, compute_dtype=BF16),
                     q, k, v, w)
    terms = edge_terms(tp[0], *(x[None] for x in (q, k, v, w)), 24 ** -0.5, slope, "f32")
    assert_grads([x[None] for x in got], [x[None] for x in want], terms)
    assert all((x[-40:] == 0).all() for x in got)


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("slope", [1.0, 0.2], ids=["ident", "leaky"])
@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("kind", ["sym", "directed"])
def test_spmm_attention_mh_ad_compute_bf16_matches_jax_grad(graphs, kind, geo, slope, heads,
                                                           plane):
    """spmm_attention_mh_ad under compute_dtype bf16 (K14's and K15's plain
    versions) against jax.grad of JAX's op under the flag, H 1 and 4,
    float32 and bf16 planes; the edgeless rows' gradients exactly 0."""
    jp, tp = graphs[kind, geo]
    q, k, v, w = (x[:heads] for x in graphs["four"])
    want = jax_mh(graphs, kind, geo, slope, heads, plane)
    got = port_grads(lambda *x: spmm_attention_mh_ad(
        tp[0], *x, plan_t=tp[1], negative_slope=slope, compute_dtype=BF16,
        plane_dtype=BF16 if plane == "bf16" else None), q, k, v, w)
    assert_grads(got, want, edge_terms(tp[0], q, k, v, w, 8 ** -0.5, slope, plane))
    assert all((x[:, -40:] == 0).all() for x in got)


@pytest.mark.parametrize("entry", ["spmm_attention_ad", "spmm_attention_mh_ad"])
def test_compute_float32_gradients_miss_by_10x(graphs, entry):
    """The rounding points matter: the compute-float32 gradients (on the
    same inputs) miss GRAD_TOL against JAX's compute bf16 ones by at least
    10x, and so do JAX's own compute-float32 gradients."""
    if entry == "spmm_attention_ad":
        tp = graphs["sym", "h32"][1]
        q, k, v, w = graphs["one"]
        want = jax_one(graphs, "sym", "h32", 0.2, True)
        got = port_grads(lambda *x: spmm_attention_ad(tp[0], *x, plan_t=tp[1],
                                                      negative_slope=0.2), q, k, v, w)
        jax_f32 = jax_one(graphs, "sym", "h32", 0.2, True, compute=jnp.float32)
    else:
        tp = graphs["sym", "h32"][1]
        q, k, v, w = graphs["four"]
        want = jax_mh(graphs, "sym", "h32", 0.2, 4, "f32")
        got = port_grads(lambda *x: spmm_attention_mh_ad(tp[0], *x, plan_t=tp[1],
                                                         negative_slope=0.2), q, k, v, w)
        jax_f32 = None
    for x, ref in zip(got, want):
        miss = np.abs(x - ref) / (TOL["atol"] + TOL["rtol"] * np.abs(ref))
        assert miss.max() >= 10, miss.max()
    if jax_f32 is not None:
        assert max((np.abs(x - ref) / (TOL["atol"] + TOL["rtol"] * np.abs(ref))).max()
                   for x, ref in zip(jax_f32, want)) >= 10


# --- the compute variants' pieces, emulated ---------------------------------------

def compute_inputs(plan, heads, dk, dv, plane, seed):
    """q, k, v, dO (H, n, d), the plain compute forward's lse and D."""
    rng = np.random.default_rng(seed)
    n = plan.num_nodes
    q, k, v, w = (torch.from_numpy(rng.standard_normal((heads, n, d)).astype(np.float32))
                  for d in (dk, dk, dv, dv))
    out, lse = spmm_attention_mh_reference(plan, q, k, v, negative_slope=0.2, return_stats=True,
                                           compute_dtype=BF16,
                                           plane_dtype=BF16 if plane == "bf16" else None)
    return q, k, v, w, lse, (w * out).sum(-1)


def emulate_compute(plan, plan_t, q, k, v, w, lse, d_row, scale, plane, limits):
    """The compute variants of K14 (dq) and K15 (dk, dv) piece by piece
    (test_torch_attention_mh.emulate_pieces): each piece's draw k, or draw
    q and bf16(p) dO, over its own edges, added in piece order."""
    qb, kb, vb, wb = (_bf16(t) for t in (q, k, v, w))
    kv_stats = (_hi_lo(lse), _hi_lo(d_row)) if plane == "bf16" else (lse, d_row)

    def coef(r, c, l_, d_):  # r: rows of q and dO, c: rows of k and v
        raw = _chain(qb[:, r], kb[:, c])
        p = torch.exp(_act(raw, scale, 0.2) - l_[:, r])
        ds = _ds(p, _chain(wb[:, r], vb[:, c]), d_[:, r], raw, scale, 0.2)
        return _bf16(ds), _bf16(p)

    def part_dq(r, c):
        return [coef(r, c, lse, d_row)[0][..., None] * kb[:, c]]

    def part_dkv(s, r):
        draw, pb = coef(r, s, *kv_stats)
        return [draw[..., None] * qb[:, r], pb[..., None] * wb[:, r]]

    heads, dk, dv = q.shape[0], q.shape[2], v.shape[2]
    dq = emulate_pieces(plan, "attention_mh_dq", limits, heads, [dk], part_dq)[0]
    return [dq, *emulate_pieces(plan_t, "attention_mh_dkv", limits, heads, [dk, dv], part_dkv)]


PIECE_CASES = {  # plan config, (heads, dk, dv), plane, piece limits
    "blocks-h1-f32": ((128, 128, 1, 2), (1, 12, 20), "f32", (1, None)),
    "work-h4-bf16": ((128, 128, 1, 4), (4, 8, 8), "bf16", (4, 60)),
    "blocks-h2-bf16": ((64, 128), (2, 8, 16), "bf16", (1, None)),
}


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_compute_pieces_emulated_match_the_plain_versions(case):
    """K14's and K15's compute variants piece by piece on a hub window cut
    into >= 8 pieces (the partials added in piece order) against their
    plain versions (to float32 order: the same draws rounded the same
    way); rows without edges exactly 0."""
    cfg, (heads, dk, dv), plane, limits = PIECE_CASES[case]
    a = power_law()
    _, (tp, _) = plans(a, dict(zip(("block_h", "block_w", "gather_segment", "block_unroll"),
                                   cfg)))
    for name in ("attention_mh_dq", "attention_mh_dkv"):
        assert np.bincount(bwd_walk(tp, name, *limits).tasks[:, 0].numpy())[0] >= 8
    q, k, v, w, lse, d_row = compute_inputs(tp, heads, dk, dv, plane, seed=40)
    scale = dk ** -0.5
    got = emulate_compute(tp, tp, q, k, v, w, lse, d_row, scale, plane, limits)
    kw = dict(scale=scale, negative_slope=0.2, compute_dtype=BF16,
              plane_dtype=BF16 if plane == "bf16" else None)
    want = [attention_mh_dq_reference(tp, q, k, v, w, lse, d_row, **kw),
            *attention_mh_dkv_reference(tp, q, k, v, w, lse, d_row, **kw)]
    for x, ref in zip(got, want):
        np.testing.assert_allclose(x.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    no_edges = np.diff(a.indptr) == 0
    assert all((x.numpy()[:, no_edges] == 0).all() for x in got)


def test_k10_compute_lanes_match_k11_k12():
    """K10's compute variant (plain version: its lane planes summed by
    hind) against K11's and K12's on a hub graph: the same draws and p, so
    dq, dk and dv agree to float32 order."""
    a = power_law()
    _, (tp, _) = plans(a, dict(block_h=128, block_w=128, block_unroll=4))
    q, k, v, w, lse, d_row = (t[0] for t in compute_inputs(tp, 1, 12, 20, "f32", seed=41))
    out, lse_f = spmm_attention_mh_reference(tp, q[None], k[None], v[None], negative_slope=0.2,
                                             return_stats=True, compute_dtype=BF16)
    kw = dict(scale=12 ** -0.5, negative_slope=0.2, compute_dtype=BF16)
    dq, dk_lane, dv_lane = attention_bwd_reference(tp, q, k, v, out[0], lse_f[0], w, **kw)
    from voltrix_spmm_tpu_torch.ops import scatter_lanes

    n = a.shape[0]
    got = [dq, scatter_lanes(tp, dk_lane, n), scatter_lanes(tp, dv_lane, n)]
    args = (q[None], k[None], v[None], w[None], lse[None], d_row[None])
    want = [attention_mh_dq_reference(tp, *args, **kw)[0],
            *(x[0] for x in attention_mh_dkv_reference(tp, *args, **kw))]
    for x, ref in zip(got, want):
        np.testing.assert_allclose(x.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)

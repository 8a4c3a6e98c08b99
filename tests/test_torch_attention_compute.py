"""compute_dtype=torch.bfloat16 on the fused attention forward (kernels
K9 and K13) against the JAX package on the CPU.

The same numpy inputs go through `spmm_attention` and `spmm_attention_mh`
of both packages under compute_dtype bf16; the JAX side runs its Pallas
kernels in interpret mode, the port the plain version
(ops/_attn_core.py:_fwd_plain_bf16), which rounds where JAX rounds: q, k
and v to bf16 before their products, p = exp(s - M) summed into l
unrounded and rounded to bf16 before its product with v, M the row's
running maximum at each of the TPU kernel's grid steps (block_unroll
blocks). out and lse agree at rtol 1e-4, atol 1e-5, the float32 tolerance:
the rounding of p alone moves out by ~2e-3 (a case below shows that
skipping it misses the limit).

The card's kernel (csrc/attn_fwd_bf16.cu) walks each piece of its work
list twice: the block maxima, then the rows from the maximum of the
window's blocks before the piece, a grid step at a time. Its steps are
emulated here piece by piece (windows cut into many pieces, grid steps
that cross the pieces' ends) against the plain version. Inputs that need
a gradient are refused before any launch (the backward's compute_dtype is
ROADMAP.md item 9); under torch.no_grad() the forward runs. A K13 call
under the flag exports with the flag in its program.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voltrix_spmm_tpu.ops import spmm_attention as jax_attention
from voltrix_spmm_tpu.ops import spmm_attention_mh as jax_mh
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.ops import (
    library,
    spmm_attention,
    spmm_attention_ad,
    spmm_attention_mh,
    spmm_attention_mh_ad,
    spmm_attention_mh_reference,
)
from voltrix_spmm_tpu_torch.ops._attn_core import _act, _edges, load_fwd_bf16_library
from voltrix_spmm_tpu_torch.ops.attention import attention_walk
from voltrix_spmm_tpu_torch.ops.block_spmm import PIECE_BLOCKS, PIECE_WORK
from voltrix_spmm_tpu_torch.serve import export_servable, load_servable

from test_torch_attention import plans, random_graph
from test_torch_bf16_weighted_int8 import assert_within_ulp

TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = torch.bfloat16
GEOMETRIES = {"h32": dict(block_h=32, block_w=128),
              "h128u2": dict(block_h=128, block_w=128, block_unroll=2)}


def bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).to(BF16).float().numpy()


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


@pytest.fixture(scope="module")
def graph():
    """A symmetric graph whose last 40 rows have no edges, both packages'
    plans at two geometries, q, k and v for one head (dk 24, dv 40) and
    four (dk 8, dv 16), and JAX's compute_dtype=bf16 forwards, each once."""
    a = random_graph(seed=1, empty_tail=40)
    n = a.shape[0]
    rng = np.random.default_rng(2)
    one = tuple(rng.standard_normal((n, d)).astype(np.float32) for d in (24, 24, 40))
    four = tuple(rng.standard_normal((4, n, d)).astype(np.float32) for d in (8, 8, 16))
    out = {"n": n, "one": one, "four": four, "jax": {}}
    for geo, cfg in GEOMETRIES.items():
        (jp, _), (tp, _) = plans(a, cfg)
        out[geo] = (jp, tp)
    return out


def jax_out(graph, key, fn):
    """JAX's (out, lse) for `key`, computed once for the module."""
    if key not in graph["jax"]:
        out, lse = fn()
        graph["jax"][key] = (np.asarray(out.astype(jnp.float32)), np.asarray(lse))
    return graph["jax"][key]


def jax_one(graph, geo, slope, dtype=np.float32):
    jp = graph[geo][0]
    q, k, v = (jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
               for x in graph["one"])
    return jax_out(graph, ("one", geo, slope, dtype), lambda: jax_attention(
        jp, q, k, v, negative_slope=slope, return_stats=True, compute_dtype=jnp.bfloat16))


@pytest.mark.parametrize("geo,slope,dtype", [("h32", 1.0, "f32"), ("h32", 0.2, "f32"),
                                             ("h128u2", 0.2, "f32"), ("h128u2", 1.0, "bf16")])
def test_spmm_attention_compute_bf16_matches_jax(graph, geo, slope, dtype):
    """K9's plain version under compute_dtype bf16 against JAX's
    spmm_attention (out and lse), float32 and bf16 q, k and v; rows without
    edges exactly 0 with lse 1e30."""
    tp = graph[geo][1]
    want, want_lse = jax_one(graph, geo, slope, dtype)
    q, k, v = (torch.from_numpy(x) for x in graph["one"])
    if dtype == "bf16":
        q, k, v = (t.to(BF16) for t in (q, k, v))
    out, lse = spmm_attention(tp, q, k, v, negative_slope=slope, return_stats=True,
                              compute_dtype=BF16)
    assert out.dtype == v.dtype and lse.dtype == torch.float32
    if dtype == "f32":
        assert_close(out.numpy(), want)
    else:  # both outputs bf16: float32 noise may round to the neighbouring value
        assert_within_ulp(out.float().numpy(), want)
    assert_close(lse.numpy(), want_lse)
    empty = graph["n"] - 40
    assert bool((out[empty:] == 0).all()) and bool((lse[empty:graph["n"]] == 1e30).all())


@pytest.mark.parametrize("geo,heads,plane,slope", [
    ("h32", 1, "f32", 1.0), ("h32", 4, "bf16", 0.2), ("h128u2", 4, "f32", 1.0),
    ("h128u2", 1, "bf16", 0.2), ("h128u2", 4, "bf16", 1.0)])
def test_spmm_attention_mh_compute_bf16_matches_jax(graph, geo, heads, plane, slope):
    """K13's plain version under compute_dtype bf16 against JAX's
    spmm_attention_mh, H 1 and 4, float32 and bf16 planes (under bf16
    planes k and v are bf16 already, and the flag adds the rounding of q and
    p)."""
    jp, tp = graph[geo]
    q, k, v = (x[:heads] for x in graph["four"])
    pdt = (jnp.bfloat16, BF16) if plane == "bf16" else (None, None)
    want, want_lse = jax_out(graph, ("four", geo, heads, plane, slope), lambda: jax_mh(
        jp, *map(jnp.asarray, (q, k, v)), negative_slope=slope, plane_dtype=pdt[0],
        return_stats=True, compute_dtype=jnp.bfloat16))
    out, lse = spmm_attention_mh(tp, *map(torch.from_numpy, (q, k, v)), negative_slope=slope,
                                 plane_dtype=pdt[1], return_stats=True, compute_dtype=BF16)
    assert_close(out.numpy(), want)
    assert_close(lse.numpy(), want_lse)


def test_skipping_the_rounding_of_p_misses_the_limit(graph):
    """The limit has teeth: q, k and v rounded to bf16 but p left in float32
    (compute_dtype float32 on the rounded inputs) misses rtol 1e-4 against
    JAX's compute_dtype bf16, and so does the float32 forward."""
    tp = graph["h32"][1]
    want, _ = jax_one(graph, "h32", 1.0)
    q, k, v = (torch.from_numpy(bf16(x)) for x in graph["one"])
    no_p = spmm_attention(tp, q, k, v).numpy()
    assert not np.allclose(no_p, want, **TOL)
    assert np.abs(no_p - want).max() > 20 * TOL["atol"]
    f32 = spmm_attention(tp, *map(torch.from_numpy, graph["one"])).numpy()
    assert not np.allclose(f32, want, **TOL)


# --- the kernel's two walks, emulated -------------------------------------------

def k13_walk(plan, piece_blocks, piece_work):
    name = "spmm_attention_mh"
    saved = PIECE_BLOCKS[name], PIECE_WORK[name]
    try:
        PIECE_BLOCKS[name], PIECE_WORK[name] = piece_blocks, piece_work
        return attention_walk(plan, name)
    finally:
        PIECE_BLOCKS[name], PIECE_WORK[name] = saved


def score_chain(q, k):
    """(H, E) scores of bf16 q and k rows, one sum in column order."""
    raw = torch.zeros(q.shape[:2])
    for c in range(q.shape[2]):
        raw = raw + q[..., c] * k[..., c]
    return raw


def emulate_bf16_kernel(plan, q, k, v, scale, slope, limits):
    """csrc/attn_fwd_bf16.cu in plain torch: pass 1's block maxima; pass 2
    over each piece, a row starting from the maximum of its window's blocks
    before the piece and, at the first edge of each grid step, taking the
    maximum of that step's blocks (rescaling l and acc), each edge adding
    exp(s - M) to l and bf16(exp(s - M)) v to acc, in the row's lane order;
    the shares of a cut group merged in piece order."""
    cfg = plan.config
    u = cfg.block_unroll
    heads, n, dv = q.shape[0], q.shape[1], v.shape[2]
    qb, kb, vb = (torch.from_numpy(bf16(x)) for x in (q, k, v))
    rows, cols, lanes = _edges(plan)
    blk = lanes // cfg.block_w
    s_all = _act(score_chain(qb[:, rows], kb[:, cols]), scale, slope)
    bmax = torch.full((heads, plan.total_blocks, cfg.block_h), -1e30)
    local = rows - plan.window_of_block.long()[blk] * cfg.block_h
    bmax.view(heads, -1).scatter_reduce_(1, (blk * cfg.block_h + local).expand(heads, -1), s_all,
                                         "amax")
    wob = plan.window_of_block.tolist()
    out = torch.zeros(heads, n, dv)
    lse = torch.full((heads, plan.padded_nodes), 1e30)
    groups = {}
    for task in k13_walk(plan, *limits).tasks.tolist():
        groups.setdefault((task[0], task[1]), []).append(task)
    for (w, g), tasks in groups.items():
        shares = []
        for _, _, b0, b1, _, _ in sorted(tasks, key=lambda t: t[4]):
            in_piece = (blk >= b0) & (blk < b1)
            share = {}
            for e in torch.nonzero(in_piece).squeeze(1).tolist():  # block, row, lane order
                r = int(rows[e])
                rw = r - w * cfg.block_h
                if not 128 * g <= rw < 128 * (g + 1):
                    continue
                if r not in share:  # the window's blocks before the piece
                    start = b0
                    while start > 0 and wob[start - 1] == w:
                        start -= 1
                    m = bmax[:, start:b0, rw].amax(1) if b0 > start else torch.full((heads,),
                                                                                    -1e30)
                    share[r] = [m, torch.zeros(heads), torch.zeros(heads, dv), -1]
                m, l, acc, step = share[r]
                first = int(blk[e]) // u * u  # the TPU's grid step: a global group of u blocks
                if first != step:
                    big = torch.maximum(m, bmax[:, first:first + u, rw].amax(1))
                    corr = torch.exp(m - big)
                    l, acc, m, step = l * corr, acc * corr[:, None], big, first
                p = torch.exp(s_all[:, e] - m)
                l = l + p
                acc = acc + torch.from_numpy(bf16(p))[:, None] * vb[:, int(cols[e])]
                share[r] = [m, l, acc, step]
            shares.append(share)
        for r in set().union(*shares):
            parts = [sh[r] for sh in shares if r in sh]
            big = torch.stack([p[0] for p in parts]).amax(0)
            den, acc = torch.zeros(heads), torch.zeros(heads, dv)
            for m, l, a, _ in parts:  # in piece order
                f = torch.exp(m - big)
                den, acc = den + l * f, acc + a * f[:, None]
            if r < n:
                out[:, r] = acc / den.clamp_min(1e-30)[:, None]
            lse[:, r] = torch.where(den > 0, big + torch.log(den.clamp_min(1e-30)), 1e30)
    return out, lse


@pytest.mark.parametrize("cfg,limits", [
    ((128, 128, 1, 2), (1, None)),   # pieces of one block: grid steps cross their ends
    ((128, 128, 1, 4), (4, 60)),     # the work limit too
    ((64, 128, 1, 2), (1, None))])
def test_bf16_kernel_emulation_matches_the_plain_version(cfg, limits):
    """The kernel's steps on a hub window cut into many pieces, at H 2,
    against the plain version (to float32 order: the same p rounded the
    same way)."""
    a = symmetrize(chung_lu_csr(1500, 15000, seed=3))
    n = a.shape[0]
    _, (tp, _) = plans(a, dict(zip(("block_h", "block_w", "gather_segment", "block_unroll"),
                                   cfg)))
    tasks = k13_walk(tp, *limits).tasks.numpy()
    assert np.bincount(tasks[:, 0])[0] >= 8  # the hub window, cut into many pieces
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, n, d)).astype(np.float32) for d in (8, 8, 12))
    got, got_lse = emulate_bf16_kernel(tp, q, k, v, 8 ** -0.5, 0.2, limits)
    want, want_lse = spmm_attention_mh_reference(tp, *map(torch.from_numpy, (q, k, v)),
                                                 negative_slope=0.2, return_stats=True,
                                                 compute_dtype=BF16)
    assert_close(got.numpy(), want.numpy(), dict(rtol=1e-5, atol=1e-6))
    assert_close(got_lse.numpy(), want_lse.numpy(), dict(rtol=1e-6, atol=1e-6))


# --- autograd, export ------------------------------------------------------------

def test_compute_bf16_refuses_autograd_and_runs_under_no_grad(graph):
    """Inputs that need a gradient raise in the forward, before any launch,
    naming ROADMAP.md item 9's backward entry; the op called directly
    raises too; under torch.no_grad() the call is the forward's."""
    tp = graph["h32"][1]
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in graph["one"])
    qh, kh, vh = (torch.from_numpy(x[:2]).requires_grad_(True) for x in graph["four"])
    with pytest.raises(NotImplementedError, match="item 9"):
        spmm_attention_ad(tp, q, k, v, plan_t=tp, compute_dtype=BF16)
    with pytest.raises(NotImplementedError, match="item 9"):
        spmm_attention_mh_ad(tp, qh, kh, vh, plan_t=tp, compute_dtype=BF16)
    with pytest.raises(NotImplementedError, match="item 9"):
        spmm_attention(tp, q, k, v, compute_dtype=BF16)
    ops, geom = library.operands(tp, "spmm_attention_mh", torch.device("cpu"))
    no_ops, no_geom = library.no_plan(ops, geom)
    with pytest.raises(NotImplementedError, match="item 9"):
        library.spmm_attention_mh_op(qh, kh, vh, ops, geom, no_ops, no_geom, no_ops, no_geom,
                                     0.3, 1.0, None, BF16)
    with torch.no_grad():
        got = spmm_attention_ad(tp, q, k, v, plan_t=tp, compute_dtype=BF16)
        got_mh = spmm_attention_mh_ad(tp, qh, kh, vh, plan_t=tp, compute_dtype=BF16)
    assert torch.equal(got, spmm_attention(tp, *(t.detach() for t in (q, k, v)),
                                           compute_dtype=BF16))
    assert torch.equal(got_mh, spmm_attention_mh(tp, *(t.detach() for t in (qh, kh, vh)),
                                                 compute_dtype=BF16))
    with pytest.raises(NotImplementedError, match="float16"):
        spmm_attention(tp, *(t.detach() for t in (q, k, v)), compute_dtype=torch.float16)


def test_export_k13_under_the_flag(graph):
    """A K13 request under compute_dtype bf16, exported and loaded: the
    eager bits, the op with the flag in the program, and the flag's library
    among the ones aot_compile loads."""
    tp = graph["h128u2"][1]
    q, k, v = (torch.from_numpy(x) for x in graph["four"])

    def request(qq):
        return spmm_attention_mh(tp, qq, k, v, compute_dtype=BF16, plane_dtype=BF16)

    eager = request(q)
    prog = load_servable(export_servable(request, q))
    assert torch.equal(prog(q), eager)
    nodes = [n for n in prog.graph.nodes if "spmm_attention_mh" in str(n.target)]
    assert nodes and library._compute_dtype_of(nodes[0]) == BF16
    assert load_fwd_bf16_library in library.loaders_of(prog)
    plain = load_servable(export_servable(lambda qq: spmm_attention_mh(tp, qq, k, v), q))
    assert load_fwd_bf16_library not in library.loaders_of(plain)

"""compute_dtype=torch.float16 on the fused attention forward (kernels K9
and K13) against the JAX package on the CPU.

JAX rounds the same operands to float16 where it rounds them to bf16
(voltrix_spmm_tpu/ops/attention.py:121-143, attention_mh.py:168-190): q
and k before the score, p = exp(s - M) and v before p v, with M the row's
running maximum at each of the TPU kernel's grid steps. A product of two
float16 values is exact in float32 (11 + 11 significant bits fit in 24),
so the port's plain version (ops/_attn_core.py:_fwd_plain_half) sums each
score in column order as under bf16, and out and lse agree with JAX's
Pallas kernels in interpret mode at the float32 tolerance, rtol 1e-4 and
atol 1e-5 (tests/test_torch_attention_compute.py holds bf16 to the same).
The scores are the same bits in both packages, but XLA's exp on the CPU
and torch.exp differ in the last float32 bit for some arguments, and a p
within that bit of a float16 rounding midpoint rounds the other way (one
float16 ulp of p, about 2e-4 of a row's out): float16's grid is 8 times
finer than bf16's, so such a p turns up on graphs of a few thousand edges.
Each row is therefore held to the tolerance under torch.exp, or under exp
moved one float32 ulp up or down (`assert_rows_close`), and the rows that
need the move are counted (at most 1% of them):

- K9 and K13 on two plan geometries with rows without edges, at H 1 and
  8, on float32 and bf16 planes (a bf16 plane's k and v are rounded again
  to float16, past 65,504 to inf and small values to subnormals, which a
  case below plants);
- a hub window cut into many pieces and that plan's window chunks
  (format/stream.py:slice_plan_windows), and windows without blocks;
- the card kernel's two walks (csrc/attn_fwd_half.cuh), emulated piece by
  piece, against the plain version;
- a control that must miss the limit: float32 compute on the rounded
  inputs, p left unrounded;
- an export of a K13 request under the flag, whose program loads the
  float16 build (csrc/attn_fwd_f16.cu) and not the bf16 one;
- what still refuses float16: the backward (spmm_attention_ad and
  spmm_attention_mh_ad on inputs that require grad, before any launch, and
  the backward ops) and plane_dtype=float16, each naming ROADMAP.md item 9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voltrix_spmm_tpu.ops import spmm_attention as jax_attention
from voltrix_spmm_tpu.ops import spmm_attention_mh as jax_mh
from voltrix_spmm_tpu_torch.data import chung_lu_csr, symmetrize
from voltrix_spmm_tpu_torch.format import slice_plan_windows
from voltrix_spmm_tpu_torch.ops import (
    attention_dq_reference,
    attention_mh_dq,
    library,
    spmm_attention,
    spmm_attention_ad,
    spmm_attention_mh,
    spmm_attention_mh_ad,
    spmm_attention_mh_reference,
    spmm_attention_reference,
)
from voltrix_spmm_tpu_torch.ops._attn_core import load_fwd_bf16_library, load_fwd_f16_library
from voltrix_spmm_tpu_torch.serve import export_servable, load_servable

from test_torch_attention import plans, random_graph
from test_torch_attention_compute import assert_close, emulate_bf16_kernel, k13_walk

TOL = dict(rtol=1e-4, atol=1e-5)
F16, BF16 = torch.float16, torch.bfloat16
GEOMETRIES = {"h32": dict(block_h=32, block_w=128),
              "h128u2": dict(block_h=128, block_w=128, block_unroll=2)}
PLANES = {"f32": (None, None), "bf16": (jnp.bfloat16, BF16)}


def f16(x):
    """float32 numpy values rounded to float16, as float32."""
    return np.array(x, np.float32).astype(np.float16).astype(np.float32)


@pytest.fixture(scope="module")
def graph():
    """A symmetric graph whose last 40 rows have no edges, both packages'
    plans at two geometries, q, k and v for one head (dk 24, dv 40) and
    eight (dk 8, dv 8), and a cache of JAX's forwards."""
    a = random_graph(seed=11, empty_tail=40)
    n = a.shape[0]
    rng = np.random.default_rng(12)
    one = tuple(rng.standard_normal((n, d)).astype(np.float32) for d in (24, 24, 40))
    eight = tuple(rng.standard_normal((8, n, 8)).astype(np.float32) for _ in range(3))
    out = {"n": n, "one": one, "eight": eight, "jax": {}}
    for geo, cfg in GEOMETRIES.items():
        (jp, _), (tp, _) = plans(a, cfg)
        out[geo] = (jp, tp)
    return out


def jax_out(cache, key, fn):
    """JAX's (out, lse) for `key`, computed once for the module."""
    if key not in cache["jax"]:
        out, lse = fn()
        cache["jax"][key] = (np.asarray(out.astype(jnp.float32)), np.asarray(lse))
    return cache["jax"][key]


def jax_one(graph, geo, slope):
    jp = graph[geo][0]
    return jax_out(graph, ("one", geo, slope), lambda: jax_attention(
        jp, *map(jnp.asarray, graph["one"]), negative_slope=slope, return_stats=True,
        compute_dtype=jnp.float16))


def assert_rows_close(monkeypatch, run, want, want_lse):
    """run() -> (out, lse) of the port's plain version against JAX's
    (want, want_lse) at TOL, row by row (the last axis), each row under
    torch.exp or under exp moved one float32 ulp up or down (see the
    module's docstring); at most 1% of the rows need the move. lse at TOL
    under torch.exp."""
    exp = torch.exp
    out, lse = run()
    assert_close(lse.numpy(), want_lse)
    want = np.asarray(want, np.float32)

    def rows_ok(got):
        got = np.asarray(got, np.float32)
        same_nan = np.isnan(got) == np.isnan(want)
        close = np.isclose(got, want, equal_nan=True, **TOL)
        return (same_nan & close).all(-1)

    ok = rows_ok(out.numpy())
    moved = ~ok
    for toward in (np.inf, -np.inf):
        if ok.all():
            break
        monkeypatch.setattr(torch, "exp", lambda x, t=toward: torch.nextafter(
            exp(x), torch.full_like(x, t)))
        ok |= rows_ok(run()[0].numpy())
        monkeypatch.setattr(torch, "exp", exp)
    assert ok.all(), f"{int((~ok).sum())} rows off JAX's under every exp"
    assert moved.mean() <= 0.01, f"{int(moved.sum())} of {moved.size} rows need exp moved"
    return out, lse


def assert_empty_rows(out, lse, n, empty):
    """Rows without edges: exactly 0, with lse exactly 1e30."""
    out, lse = np.asarray(out), np.asarray(lse)
    assert (out[..., n - empty:n, :] == 0).all() and (lse[..., n - empty:n] == 1e30).all()


# --- K9 and K13 against JAX ------------------------------------------------------

@pytest.mark.parametrize("geo,slope", [("h32", 1.0), ("h32", 0.2), ("h128u2", 0.2)])
def test_spmm_attention_compute_f16_matches_jax(monkeypatch, graph, geo, slope):
    """K9's plain version under compute_dtype float16 against JAX's
    spmm_attention: out and lse at the float32 tolerance."""
    tp = graph[geo][1]
    want, want_lse = jax_one(graph, geo, slope)
    out, lse = assert_rows_close(monkeypatch, lambda: spmm_attention(
        tp, *map(torch.from_numpy, graph["one"]), negative_slope=slope, return_stats=True,
        compute_dtype=F16), want, want_lse)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert_empty_rows(out, lse, graph["n"], 40)


@pytest.mark.parametrize("geo,heads,plane,slope", [
    ("h32", 1, "f32", 1.0), ("h32", 8, "bf16", 0.2), ("h128u2", 8, "f32", 0.2),
    ("h128u2", 1, "bf16", 1.0), ("h128u2", 8, "bf16", 1.0)])
def test_spmm_attention_mh_compute_f16_matches_jax(monkeypatch, graph, geo, heads, plane,
                                                   slope):
    """K13's plain version under compute_dtype float16 against JAX's
    spmm_attention_mh, H 1 and 8, float32 and bf16 planes (a bf16 plane's k
    and v rounded to bf16, then to float16)."""
    jp, tp = graph[geo]
    q, k, v = (x[:heads] for x in graph["eight"])
    jdt, tdt = PLANES[plane]
    want, want_lse = jax_out(graph, ("eight", geo, heads, plane, slope), lambda: jax_mh(
        jp, *map(jnp.asarray, (q, k, v)), negative_slope=slope, plane_dtype=jdt,
        return_stats=True, compute_dtype=jnp.float16))
    out, lse = assert_rows_close(monkeypatch, lambda: spmm_attention_mh(
        tp, *map(torch.from_numpy, (q, k, v)), negative_slope=slope, plane_dtype=tdt,
        return_stats=True, compute_dtype=F16), want, want_lse)
    assert_empty_rows(out, lse, graph["n"], 40)


def test_skipping_the_rounding_of_p_misses_the_limit(graph):
    """The limit has teeth: q, k and v rounded to float16 but p left in
    float32 (compute_dtype float32 on the rounded inputs) misses rtol 1e-4
    against JAX's compute_dtype float16, and so does the float32 forward;
    the bf16 forward is further off still."""
    tp = graph["h32"][1]
    want, _ = jax_one(graph, "h32", 1.0)
    no_p = spmm_attention(tp, *(torch.from_numpy(f16(x)) for x in graph["one"])).numpy()
    assert not np.allclose(no_p, want, **TOL)
    assert np.abs(no_p - want).max() > 5 * TOL["atol"]
    xs = tuple(map(torch.from_numpy, graph["one"]))
    assert not np.allclose(spmm_attention(tp, *xs).numpy(), want, **TOL)
    bf = spmm_attention(tp, *xs, compute_dtype=BF16).numpy()
    assert np.abs(bf - want).max() > np.abs(no_p - want).max()


def test_bf16_plane_past_the_f16_range(monkeypatch, graph):
    """A bf16 plane holding k = 70,144 (past 65,504: inf in float16) and v
    values near 3e-6 in column 3 (float16 subnormals): both packages round
    them again under compute_dtype float16, so their NaN rows and their
    outputs agree, column 3 divided by 3e-6 (the tolerance taken relative
    to its scale: flushing the subnormals to 0 would miss it by 1)."""
    jp, tp = graph["h32"]
    q, k, v = (x[:2].copy() for x in graph["eight"])
    k[0, 5, 0] = 7e4
    v[:, :, 3] *= 3e-6
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), negative_slope=0.2,
                            plane_dtype=jnp.bfloat16, return_stats=True,
                            compute_dtype=jnp.float16)
    want = np.asarray(want.astype(jnp.float32))
    sub = want[..., 3][np.isfinite(want[..., 3]) & (want[..., 3] != 0)]
    assert (np.abs(sub) < 6.1e-5).all()  # float16 subnormals
    unit = np.ones(8, np.float32)
    unit[3] = 3e-6

    def run():
        out, lse = spmm_attention_mh(tp, *map(torch.from_numpy, (q, k, v)), negative_slope=0.2,
                                     plane_dtype=BF16, return_stats=True, compute_dtype=F16)
        return out / torch.from_numpy(unit), lse

    out, lse = assert_rows_close(monkeypatch, run, want / unit, want_lse)
    # rows whose score with node 5 is +inf: p = exp(inf - inf) is NaN, so
    # out is NaN and lse the empty rows' 1e30 (l > 0 fails), in both
    bad = np.isnan(want).any(-1)
    assert bad[0].any() and not bad[1].any()
    np.testing.assert_array_equal(np.isnan(out.numpy()).any(-1), bad)
    assert (lse.numpy()[:, :graph["n"]][bad] == 1e30).all()
    assert (np.asarray(want_lse)[:, :graph["n"]][bad] == 1e30).all()


# --- hub windows cut into pieces, window chunks, empty windows -----------------

@pytest.fixture(scope="module")
def hub():
    """A power-law graph whose first window holds the hubs, both packages'
    plans at PlanConfig(128, 128, 1, 4), 8 heads of q, k and v, and JAX's
    compute_dtype=float16 forward on bf16 planes."""
    a = symmetrize(chung_lu_csr(1500, 15000, seed=3))
    n = a.shape[0]
    (jp, _), (tp, _) = plans(a, dict(block_h=128, block_w=128, gather_segment=1,
                                     block_unroll=4))
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((8, n, 8)).astype(np.float32) for _ in range(3))
    want, want_lse = jax_mh(jp, *map(jnp.asarray, (q, k, v)), negative_slope=0.2,
                            plane_dtype=jnp.bfloat16, return_stats=True,
                            compute_dtype=jnp.float16)
    return dict(tp=tp, qkv=(q, k, v), want=np.asarray(want), want_lse=np.asarray(want_lse))


@pytest.mark.parametrize("num_chunks", [1, 2, 3])
def test_hub_windows_and_window_chunks_match_jax(monkeypatch, hub, num_chunks):
    """K13's plain version under compute_dtype float16 on the plan's window
    chunks (one chunk: the whole plan; each chunk its own rows of q)
    against JAX on the whole plan; the hub window is cut into many pieces
    on the card."""
    tp = hub["tp"]
    assert np.bincount(k13_walk(tp, 4, 60).tasks.numpy()[:, 0])[0] >= 8
    tq, tk, tv = map(torch.from_numpy, hub["qkv"])

    def run():
        outs, lses, r0 = [], [], 0
        for sub in slice_plan_windows(tp, num_chunks):
            out, lse = spmm_attention_mh_reference(sub, tq[:, r0:r0 + sub.num_nodes], tk, tv,
                                                   negative_slope=0.2, plane_dtype=BF16,
                                                   return_stats=True, compute_dtype=F16)
            outs.append(out)
            lses.append(lse)
            r0 += sub.num_nodes
        return torch.cat(outs, 1), torch.cat(lses, 1)

    assert_rows_close(monkeypatch, run, hub["want"], hub["want_lse"])


def test_windows_without_blocks_match_jax(monkeypatch):
    """K9's plain version under compute_dtype float16 on a plan with
    windows left without blocks, against JAX: those rows 0 with lse 1e30."""
    a = random_graph(seed=5, n=2560, density=0.004, empty_tail=2200)
    (jp, _), (tp, _) = plans(a, dict(block_h=32, block_w=128))
    assert tp.has_empty_windows
    n = a.shape[0]
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32) for d in (12, 12, 20))
    want, want_lse = jax_attention(jp, *map(jnp.asarray, (q, k, v)), negative_slope=0.2,
                                   return_stats=True, compute_dtype=jnp.float16)
    out, lse = assert_rows_close(monkeypatch, lambda: spmm_attention(
        tp, *map(torch.from_numpy, (q, k, v)), negative_slope=0.2, return_stats=True,
        compute_dtype=F16), np.asarray(want), np.asarray(want_lse))
    assert_empty_rows(out, lse, n, 2200)


@pytest.mark.parametrize("cfg,limits,plane", [
    ((128, 128, 1, 2), (1, None), None),   # pieces of one block: grid steps cross their ends
    ((128, 128, 1, 4), (4, 60), BF16),     # the work limit too, on a bf16 plane
    ((64, 128, 1, 2), (1, None), BF16)])
def test_f16_kernel_emulation_matches_the_plain_version(cfg, limits, plane):
    """The card kernel's steps at compute type float16 on a hub window cut
    into many pieces, at H 2, against the plain version (to float32 order:
    the same p rounded the same way)."""
    a = symmetrize(chung_lu_csr(1500, 15000, seed=3))
    n = a.shape[0]
    _, (tp, _) = plans(a, dict(zip(("block_h", "block_w", "gather_segment", "block_unroll"),
                                   cfg)))
    assert np.bincount(k13_walk(tp, *limits).tasks.numpy()[:, 0])[0] >= 8
    rng = np.random.default_rng(15)
    q, k, v = (rng.standard_normal((2, n, d)).astype(np.float32) for d in (8, 8, 12))
    got, got_lse = emulate_bf16_kernel(tp, q, k, v, 8 ** -0.5, 0.2, limits, half=F16, pdt=plane)
    want, want_lse = spmm_attention_mh_reference(tp, *map(torch.from_numpy, (q, k, v)),
                                                 negative_slope=0.2, plane_dtype=plane,
                                                 return_stats=True, compute_dtype=F16)
    assert_close(got.numpy(), want.numpy(), dict(rtol=1e-5, atol=1e-6))
    assert_close(got_lse.numpy(), want_lse.numpy(), dict(rtol=1e-6, atol=1e-6))


# --- export, and what still refuses float16 --------------------------------------

def test_export_k13_under_the_f16_flag(graph):
    """A K13 request under compute_dtype float16, exported and loaded: the
    eager bits, the op with the flag in the program, and the float16 build
    among the libraries aot_compile loads (not the bf16 one)."""
    tp = graph["h128u2"][1]
    q, k, v = (torch.from_numpy(x) for x in graph["eight"])

    def request(qq):
        return spmm_attention_mh(tp, qq, k, v, compute_dtype=F16, plane_dtype=BF16)

    eager = request(q)
    prog = load_servable(export_servable(request, q))
    assert torch.equal(prog(q), eager)
    nodes = [n for n in prog.graph.nodes if "spmm_attention_mh" in str(n.target)]
    assert nodes and library._compute_dtype_of(nodes[0]) == F16
    loaders = library.loaders_of(prog)
    assert load_fwd_f16_library in loaders and load_fwd_bf16_library not in loaders


def test_f16_refusals_that_stay(graph):
    """The float16 backward raises NotImplementedError naming ROADMAP.md
    item 9 before any forward runs, where an input requires grad; under
    torch.no_grad() the differentiable entry points are the forward. The
    backward ops refuse compute_dtype float16, and K13 refuses a float16
    plane, naming the item."""
    tp = graph["h32"][1]
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in graph["one"])
    qh, kh, vh = (torch.from_numpy(x[:2]).requires_grad_(True) for x in graph["eight"])
    calls = spmm_attention_reference.calls, spmm_attention_mh_reference.calls
    with pytest.raises(NotImplementedError, match="float16.*ROADMAP.md item 9"):
        spmm_attention_ad(tp, q, k, v, plan_t=tp, compute_dtype=F16)
    with pytest.raises(NotImplementedError, match="float16.*ROADMAP.md item 9"):
        spmm_attention_mh_ad(tp, qh, kh, vh, plan_t=tp, compute_dtype=F16)
    assert (spmm_attention_reference.calls, spmm_attention_mh_reference.calls) == calls
    with torch.no_grad():
        got = spmm_attention_ad(tp, q, k, v, plan_t=tp, compute_dtype=F16)
        got_mh = spmm_attention_mh_ad(tp, qh, kh, vh, plan_t=tp, compute_dtype=F16)
    assert torch.equal(got, spmm_attention(tp, *(t.detach() for t in (q, k, v)),
                                           compute_dtype=F16))
    assert torch.equal(got_mh, spmm_attention_mh(tp, *(t.detach() for t in (qh, kh, vh)),
                                                 compute_dtype=F16))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    out, lse = spmm_attention(tp, qd, kd, vd, return_stats=True)
    bwd = (qd, kd, vd, out, lse, out.sum(-1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
        attention_dq_reference(tp, *bwd, scale=0.2, compute_dtype=F16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 9"):
        attention_mh_dq(tp, *(t[None] for t in bwd), scale=0.2, compute_dtype=F16)
    with pytest.raises(ValueError, match="plane_dtype.*ROADMAP.md item 9"):
        spmm_attention_mh(tp, qh.detach(), kh.detach(), vh.detach(), plane_dtype=F16)

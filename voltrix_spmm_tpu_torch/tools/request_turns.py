"""Host and request times on the launch-bound paths, to compare two trees
of the port in turns (one process per tree and turn).

    python3 -m voltrix_spmm_tpu_torch.tools.request_turns --label change

prints one JSON line: the host microseconds of one `spmm(plan, x)` call on
a 256-node plan at d 8 (2000 calls, the launch alone costs), and CUDA-event
milliseconds (20 calls after 3 warm-up) of chip_smoke.py's path A request
(GCN 128 -> 256 -> 40 on the ogbn-arxiv proxy, PlanConfig(128, 128)),
path M's request and Adam step (GIN classifier on 128 block-diagonal
graphs), path L's Adam step on one fixed sampled batch (SAGE 128 ->
256 -> 40, 512 seeds, fanouts [10, 25], PlanConfig(32, 128)), and on A's
graph with self-loops at 128 -> 8 heads x 8 -> 40: path D's GAT request
(PlanConfig(64, 128), K4), path E's dot-product GAT request and Adam step
(ELL plans PlanConfig(128, 128, block_unroll=4), K6 and K7) and path G's
flash GAT request (the same geometry, bf16 planes, K13), each with its
host wall time per call. It uses only entry points that the port had
before its kernels became registered ops, so it runs on either tree: to
compare, unpack the other tree with `git archive` into a git-ignored
directory, copy this file into its tools/, and run parent, change, change,
parent in one chip call with one VOLTRIX_TORCH_BUILD_DIR.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import torch


def timed(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(CUDA-event ms, host wall ms) per call of fn() over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    args = p.parse_args(argv)

    import voltrix_spmm_tpu_torch as vt
    from voltrix_spmm_tpu_torch.data import (block_diagonal, erdos_renyi_csr, gather_features,
                                             node_graph_ids, proxy_csr, sample_blocks, symmetrize)
    from voltrix_spmm_tpu_torch.models import (GINClassifier, SageMinibatch, blocks_args,
                                               gin_classifier_forward, make_classifier_train_step,
                                               make_sage_minibatch_step)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rec = {"label": args.label, "card": smi, "torch": torch.__version__}

    # the host cost of one call, where the launch is the work
    small = erdos_renyi_csr(256, 0.02, seed=0)
    plan = vt.csr_preprocess(small.indptr, small.indices, 256).to(dev)
    x8 = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 8)).astype(
        np.float32)).to(dev)
    for _ in range(20):
        vt.spmm(plan, x8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        vt.spmm(plan, x8)
    torch.cuda.synchronize()
    rec["host_us_spmm_call"] = (time.perf_counter() - t0) / 2000 * 1e6

    # path A's request
    a = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    n = a.shape[0]
    g = vt.build_graph(a.indptr, a.indices, n, vt.PlanConfig(128, 128), symmetric=True,
                       device=dev)
    rng = np.random.default_rng(1)
    params = vt.gcn_params_from_jax({
        "w1": rng.standard_normal((128, 256)) * (2.0 / 128) ** 0.5,
        "b1": rng.standard_normal(256) * 0.1,
        "w2": rng.standard_normal((256, 40)) * (2.0 / 256) ** 0.5,
        "b2": rng.standard_normal(40) * 0.1}, dev)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(dev)
    with torch.no_grad():
        rec["a_request_ms"], rec["a_request_wall_ms"] = timed(lambda: vt.gcn_forward(params, g, x))
    del g

    # paths D, E and G: A's graph with self-loops, 128 -> 8 heads x 8 -> 40
    loops = ((a + sp.eye(n, format="csr")) != 0).astype(np.float32).tocsr()
    loops.sort_indices()
    y = torch.from_numpy(rng.integers(0, 40, n)).to(dev)
    gen = torch.Generator().manual_seed(3)
    gd = vt.build_gat_graph(loops.indptr, loops.indices, n, vt.PlanConfig(64, 128), device=dev)
    gat = vt.GAT(128, 8, 40, 8, generator=gen, device=dev)
    with torch.no_grad():
        rec["d_request_ms"], rec["d_request_wall_ms"] = timed(lambda: gat(gd, x))
    del gd
    cfg = vt.PlanConfig(128, 128, block_unroll=4)
    ge = vt.build_ell_graph(loops.indptr, loops.indices, n, cfg, device=dev)
    dot = vt.GATDot(128, 8, 40, 8, generator=gen, device=dev)
    with torch.no_grad():
        rec["e_request_ms"], rec["e_request_wall_ms"] = timed(lambda: dot(ge, x))
    dot_step = vt.make_train_step(torch.optim.Adam(dot.parameters(), lr=5e-3), vt.gat_dot_loss)
    rec["e_step_ms"], rec["e_step_wall_ms"] = timed(lambda: dot_step(dot.params(), ge, x, y))
    del ge
    gg = vt.build_graph(loops.indptr, loops.indices, n, cfg, symmetric=True, device=dev)
    flash = vt.GATFlash(128, 8, 40, 8, generator=gen, device=dev)
    with torch.no_grad():
        rec["g_request_ms"], rec["g_request_wall_ms"] = timed(lambda: flash(gg, x))
    del gg

    # path M: the GIN classifier on 128 graphs of 30-80 nodes
    rng = np.random.default_rng(0)
    graphs, labels = [], []
    for i in range(128):
        m = int(rng.integers(30, 80))
        if i % 2 == 0:
            b = sp.random(m, m, density=0.25, format="csr", random_state=rng)
        else:
            ii = np.arange(m)
            b = sp.csr_matrix((np.ones(m, np.float32), (ii, (ii + 1) % m)), shape=(m, m))
        graphs.append(((b + b.T) != 0).astype(np.float32).tocsr())
        labels.append(i % 2)
    big, offs = block_diagonal(graphs)
    gm = vt.build_graph(big.indptr, big.indices, big.shape[0], vt.PlanConfig(128, 128),
                        symmetric=True, device=dev)
    ids = torch.from_numpy(node_graph_ids(offs).astype(np.int64)).to(dev)
    xm = torch.from_numpy(rng.standard_normal((big.shape[0], 16)).astype(np.float32)).to(dev)
    ym = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    model = GINClassifier(16, 64, 2, generator=torch.Generator().manual_seed(36), device=dev)
    with torch.no_grad():
        rec["m_request_ms"], rec["m_request_wall_ms"] = timed(
            lambda: gin_classifier_forward(model.params(), gm, xm, ids, 128))
    step = make_classifier_train_step(torch.optim.Adam(model.parameters(), lr=5e-3))
    rec["m_step_ms"], rec["m_step_wall_ms"] = timed(lambda: step(model.params(), gm, xm, ids, ym))

    # path L: one sampled batch, the step alone
    seeds = np.random.default_rng(25).choice(n, size=512, replace=False)
    blocks = sample_blocks(a.indptr, a.indices, seeds, [10, 25], np.random.default_rng(26),
                           vt.PlanConfig(32, 128))
    plans, inv_degs = blocks_args(blocks, dev)
    x_full = torch.from_numpy(np.random.default_rng(24).standard_normal((n, 128)).astype(
        np.float32)).to(dev)
    x_src = gather_features(x_full, blocks[0].src_ids)
    y = torch.from_numpy(np.random.default_rng(27).integers(0, 40, 512)).to(dev)
    sage = SageMinibatch([128, 256, 40], generator=torch.Generator().manual_seed(35), device=dev)
    sage_step = make_sage_minibatch_step(torch.optim.Adam(sage.parameters(), lr=1e-2))
    rec["l_step_ms"], rec["l_step_wall_ms"] = timed(
        lambda: sage_step(sage.params(), plans, inv_degs, x_src, y))
    loss = sage_step(sage.params(), plans, inv_degs, x_src, y)
    if not bool(torch.isfinite(loss)):
        raise SystemExit(f"request_turns: the SAGE loss is {loss.item()}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""One training step of every parallel mode against a dense oracle: the
port of the JAX package's `__graft_entry__.dryrun_multichip`.

    python3 -m voltrix_spmm_tpu_torch.parallel.dryrun [n_devices] [--device cpu]

On `n_devices` ranks of `comm.launch` (the card by default: under NCCL
when every rank has a card of its own, else under gloo with the ranks
sharing the cards; with device "cpu", CPU tensors under gloo) it takes one
SGD step (lr 1e-2), through `checks.train_cases`, of

1. the dp x tp batched trainer (`make_mesh(n_devices)`, a batch of dp);
2. the row-sharded full-graph trainer, degree-balanced, with transposes;
3. the ring trainer;
4. the hybrid trainer on a (host, chip) mesh;
5. the 2D-grid trainer on a (row, col) mesh,

on the JAX dryrun's problem (a symmetric Erdos-Renyi graph of n nodes at
density 0.02, d features, hidden 8 x tp, 4 classes, PlanConfig(32, 128);
features and labels `checks.problem_arrays` from seed 0; n 256 and d 32
unless asked), and holds each loss and updated parameter set against a
float64 dense oracle on the host: loss rel < 1e-4 and update max |delta| <
1e-4; and each rank's block SpMMs: K1 launched 3 times a step (3 x ranks
on the ring and hybrid) on the card, its plain version as often on the
CPU, the other never. A gate that fails raises RuntimeError.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..format.plan import PlanConfig
from . import checks, comm

LR = 1e-2
GATE = 1e-4  # loss rel and update max |delta|, as the JAX dryrun
MODES = ("dp_tp", "row_sharded", "ring", "hybrid", "grid2d")


def mesh_shapes(n_devices: int) -> dict:
    """The meshes of the dryrun: (dp, tp) by `make_mesh`'s rule, (nhost,
    nchip) and (nrow, ncol) with 4, else 2, else 1 on the inner axis."""
    from .sharded import dp_tp

    inner = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    return {"dp_tp": dp_tp(n_devices), "hybrid": (n_devices // inner, inner),
            "grid2d": (n_devices // inner, inner)}


def build_problem(n_devices: int, params=None, n: int = 256, d: int = 32) -> dict:
    """The graph, mesh shapes and `checks.train_cases` spec of the dryrun
    (its parameters the JAX layout as numpy; default the port's `GCN`
    initialiser from torch seed 0): one case a mode, named by the mode."""
    from ..data import erdos_renyi_csr, symmetrize
    from ..models import GCN
    from .grid2d import build_grid2d_plan
    from .ring import build_ring_sharded_plan
    from .row_sharded import build_row_sharded_plan

    shapes = mesh_shapes(n_devices)
    dp, tp = shapes["dp_tp"]
    hidden, classes, cfg = 8 * tp, 4, PlanConfig(32, 128)
    a = symmetrize(erdos_renyi_csr(n, 0.02, seed=0))
    if params is None:
        model = GCN(d, hidden, classes, generator=torch.Generator().manual_seed(0), device="cpu")
        params = {k: v.detach().numpy() for k, v in model.params().items()}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    rs_plan = build_row_sharded_plan(a.indptr, a.indices, n, n_devices, cfg,
                                     with_transpose=True, balance=True)
    ring_plan = build_ring_sharded_plan(a.indptr, a.indices, n, n_devices, cfg,
                                        with_transpose=True)
    g2_plan = build_grid2d_plan(a.indptr, a.indices, n, *shapes["grid2d"], cfg,
                                with_transpose=True)
    if not ring_plan.num_nodes == g2_plan.num_nodes == rs_plan.num_nodes:
        raise ValueError("the modes' padded sizes differ")
    cases = [{"name": "dp_tp", "mode": "dp_tp", "mesh": shapes["dp_tp"]},
             {"name": "row_sharded", "mode": "row_sharded", "plan": rs_plan},
             {"name": "ring", "mode": "ring", "plan": ring_plan},
             {"name": "hybrid", "mode": "hybrid", "plan": ring_plan, "mesh": shapes["hybrid"]},
             {"name": "grid2d", "mode": "grid2d", "plan": g2_plan, "mesh": shapes["grid2d"]}]
    spec = {"indptr": a.indptr, "indices": a.indices, "n": n, "cfg": cfg, "params": params,
            "d": d, "classes": classes, "seed": 0, "batch": dp, "lr": LR, "steps": 1,
            "cases": cases}
    return {"a": a, "n_pad": rs_plan.num_nodes, "shapes": shapes, "spec": spec}


def dense_steps(prob: dict) -> dict:
    """The float64 dense oracle's (new parameters, loss) of the batched and
    of the full-graph problem, on the host."""
    a, n_pad, spec = prob["a"], prob["n_pad"], prob["spec"]
    n = spec["n"]
    arr = checks.problem_arrays(spec["indptr"], n, n_pad, spec["d"], spec["classes"],
                                spec["seed"], spec["batch"])
    ad = torch.zeros(n_pad, n_pad, dtype=torch.float64)
    ad[:n, :n] = torch.from_numpy(a.toarray().astype(np.float64))
    invd = torch.from_numpy(arr["inv_deg"].astype(np.float64)).reshape(-1, 1)
    p0 = {k: torch.from_numpy(v.astype(np.float64)) for k, v in spec["params"].items()}

    def gcn(p, x, rows=slice(None)):
        h = invd[rows] * (ad[rows, rows] @ x)
        h = torch.relu(h @ p["w1"] + p["b1"])
        h = invd[rows] * (ad[rows, rows] @ h)
        return h @ p["w2"] + p["b2"]

    def step(loss_fn):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss, list(p.values()))
        return {k: (v - LR * gr).detach().numpy() for (k, v), gr in zip(p.items(), grads)}, \
            loss.item()

    x = torch.from_numpy(arr["xb"].astype(np.float64))
    y = torch.from_numpy(arr["yb"]).long()
    xf = torch.from_numpy(arr["x"].astype(np.float64))
    yf = torch.from_numpy(arr["y"]).long()

    def batch_loss(p):
        return torch.stack([F.cross_entropy(gcn(p, x[b], slice(0, n)), y[b])
                            for b in range(x.shape[0])]).mean()

    def full_loss(p):
        losses = F.cross_entropy(gcn(p, xf), yf.clamp_min(0), reduction="none")
        mask = yf >= 0
        return torch.where(mask, losses, torch.zeros_like(losses)).sum() / mask.sum().clamp_min(1)

    return {"batch": step(batch_loss), "full": step(full_loss)}


def _max_delta(p: dict, q: dict) -> float:
    return max(float(np.abs(np.asarray(p[k], np.float64) - q[k]).max()) for k in q)


def check(prob: dict, ranks: list, device: str) -> dict:
    """Each mode's loss rel and update max |delta| against the oracle;
    raises RuntimeError past the gates, where the ranks disagree, or where
    a rank's block SpMMs were not K1's launches on the card (its plain
    version's calls on the CPU), 3 a step (3 x ranks on the ring and
    hybrid)."""
    from .sharded import full_gcn_params

    oracle = dense_steps(prob)
    dp, tp = prob["shapes"]["dp_tp"]
    report = {}
    for mode in MODES:
        res = [r[mode] for r in ranks]
        want_calls = 3 * (len(ranks) if mode in ("ring", "hybrid") else 1)
        runs = [(r["launches"], r["plain_calls"]) for r in res]
        if runs != [(want_calls, 0) if device == "cuda" else (0, want_calls)] * len(res):
            raise RuntimeError(f"{mode}: (K1 launches, plain calls) by rank {runs}, want "
                               f"{want_calls} {'launches' if device == 'cuda' else 'plain calls'}"
                               f" a rank")
        if mode == "dp_tp":
            slices = {r["coords"]: r["params"] for r in res}
            got = full_gcn_params([slices[(0, j)] for j in range(tp)])
            spread = max(_max_delta(full_gcn_params([slices[(i, j)] for j in range(tp)]), got)
                         for i in range(dp))
            want, want_loss = oracle["batch"]
        else:
            got = res[0]["params"]
            spread = max(_max_delta(r["params"], got) for r in res)
            want, want_loss = oracle["full"]
        losses = [r["losses"][0] for r in res]
        rel = abs(losses[0] - want_loss) / max(abs(want_loss), 1e-9)
        delta = _max_delta(got, want)
        report[mode] = {"loss": losses[0], "oracle_loss": want_loss, "loss_rel": rel,
                        "update_max_delta": delta, "k1_per_rank": res[0]["launches"]}
        if spread != 0.0 or len(set(losses)) != 1:
            raise RuntimeError(f"{mode}: the ranks disagree (params by {spread:.2e}, losses "
                               f"{losses})")
        if not (rel < GATE and delta < GATE):
            raise RuntimeError(f"{mode}: loss {losses[0]} against the dense oracle's "
                               f"{want_loss} (rel {rel:.2e}), update max|delta| {delta:.2e}")
    return report


def dryrun_multichip(n_devices: int, device: str = "cuda", params=None, n: int = 256,
                     d: int = 32, timeout: float = 300.0) -> dict:
    """Build the problem, take each mode's step on `n_devices` ranks of
    `device` ("cuda", the default, or "cpu") and hold it against the dense
    oracle (see the module's docstring); print one line and return the
    report (by mode: loss, oracle loss, loss rel, update max |delta|, K1
    launches a rank; and the seconds)."""
    t0 = time.perf_counter()
    prob = build_problem(n_devices, params, n, d)
    if device == "cuda":
        from ..ops.block_spmm import load_library

        load_library()  # K1 built once here, not by every rank
    ranks = comm.launch(checks.train_cases, n_devices, prob["spec"], device, device=device,
                        timeout=timeout)
    report = check(prob, ranks, device)
    report["seconds"] = time.perf_counter() - t0
    dp, tp = prob["shapes"]["dp_tp"]
    print(f"dryrun_multichip ok: {n_devices} ranks ({comm.default_backend(n_devices, device)}, "
          f"{device}), dp {dp} x tp {tp}, hybrid {prob['shapes']['hybrid']}, grid2d "
          f"{prob['shapes']['grid2d']} | "
          + ", ".join(f"{m} loss {r['loss']:.6f} rel {r['loss_rel']:.2e} update max|d| "
                      f"{r['update_max_delta']:.2e}" for m, r in report.items()
                      if isinstance(r, dict))
          + f" | {report['seconds']:.1f} s")
    return report


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = "cuda"
    if "--device" in args:
        k = args.index("--device")
        dev = args[k + 1]
        del args[k: k + 2]
    dryrun_multichip(int(args[0]) if args else 4, device=dev)

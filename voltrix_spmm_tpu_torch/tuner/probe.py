"""One tuning candidate timed in a process of its own (counterpart of
voltrix_spmm_tpu/tuner/probe.py):

    python -m voltrix_spmm_tpu_torch.tuner.probe SPEC.json

builds the candidate's plan, times it with the tuner's timer (`gpu_bench`
on the card, `CPU_bench` on the CPU) and prints one JSON line. The tuner
starts one probe a candidate when `isolate` is on: the process's exit frees
everything the candidate held on the card, plans and work lists included.
The probe imports the package and takes a CUDA context (about 6.5 s on the
card, PERF.md section 5) and loads the kernels the parent built into
build/kernels; it builds none of its own when the parent built them.

Spec JSON:
    {"csr": path.npz (indptr, indices[, values]), "num_nodes": N, "d": D,
     "feat_dtype": "float32", "variant": {Variant fields},
     "ordering": "identity", "iters": 8, "backend": "auto", "device": "cuda"}
Output (the last line): {"ok": true, "time_ms": t, "plan_s": s,
"peak_bytes": b}, or
{"ok": false, "invalid": true|false, "error": "..."}: invalid for a
geometry refusal or running out of memory (the candidate is skipped),
false for any other failure (the race stops). peak_bytes (on the card
only) is `torch.cuda.max_memory_allocated` over the candidate's first call:
its plan, work list, workspace, features and output, which the tuner's
`estimate_residency` predicts.
"""

from __future__ import annotations

import json
import sys


def run_probe(spec: dict, out: dict) -> dict:
    import time

    import numpy as np
    import torch

    from .tuner import (Variant, _bench, _perm_tensors, _reorder, _run_variant,
                        build_variant_plan, peak_bytes)

    z = np.load(spec["csr"])
    indptr, indices = z["indptr"], z["indices"]
    values = z["values"] if "values" in z.files else None
    num_nodes = int(spec["num_nodes"])
    device = torch.device(spec.get("device", "cuda"))
    variant = Variant(**spec["variant"])
    ptr, idx, vals, perm = _reorder(spec.get("ordering", "identity"), indptr, indices,
                                    num_nodes, values)
    t0 = time.perf_counter()
    plan = build_variant_plan(variant, ptr, idx, num_nodes, vals,
                              backend=spec.get("backend", "auto"),
                              weighted=values is not None, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["plan_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    # the time depends on the shapes and the plan, not on the feature values
    dtype = getattr(torch, spec.get("feat_dtype", "float32"))
    feat = torch.from_numpy(rng.standard_normal((num_nodes, int(spec["d"])), np.float32)
                            ).to(device=device, dtype=dtype)
    pe, ip = _perm_tensors(perm, device)

    def run():
        return _run_variant(variant, plan, feat, pe, ip)

    peak = peak_bytes(run, device)  # the process holds nothing else on the card
    if peak is not None:
        out["peak_bytes"] = peak
    out.update(ok=True, time_ms=float(_bench(run, device, int(spec.get("iters", 8)))))
    return out


def main(argv) -> int:
    from .tuner import candidate_invalid

    with open(argv[1]) as f:
        spec = json.load(f)
    out: dict = {}
    try:
        run_probe(spec, out)
    except Exception as e:  # noqa: BLE001 - the parent reads ok / invalid
        out.update(ok=False, invalid=candidate_invalid(e), error=f"{type(e).__name__}: {e}")
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""Which collectives take CUDA tensors as they are, by backend: the source
of `parallel.comm.STAGED`.

    python3 -m voltrix_spmm_tpu_torch.tools.gloo_probe

For each op of `parallel/comm.py` (all_gather, psum_scatter, psum,
ppermute) and each device of its tensors (cpu, cuda), one launch of two
gloo ranks sharing cuda:0 runs the op with nothing staged and checks its
result; and one NCCL rank runs each op on CUDA tensors. Each case is a
launch of its own with a short timeout, so an op that raises, hangs or
kills its process is reported without stopping the others. Prints one
line per case and, last, the (backend, op) pairs whose CUDA tensors must
go through host memory.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

OPS = ("all_gather", "psum_scatter", "psum", "ppermute")


def run_op(rank: int, world_size: int, op: str, device: str) -> bool:
    """`op` of parallel/comm.py with nothing staged on tensors of `device`:
    whether its result is right."""
    import torch
    import torch.distributed as dist

    from ..parallel import comm

    comm.STAGED = frozenset()  # this rank process only: every op as it is
    dev = comm.rank_device(device)
    group = dist.group.WORLD
    n = world_size
    x = torch.arange(8, dtype=torch.float32, device=dev).reshape(4, 2) + 100 * rank
    if op == "all_gather":
        got = comm.all_gather(x, group)
        want = torch.cat([x - 100 * rank + 100 * r for r in range(n)])
    elif op == "psum_scatter":
        got = comm.psum_scatter(torch.cat([x] * n), group)
        want = sum(x - 100 * rank + 100 * r for r in range(n))
    elif op == "psum":
        got = comm.psum(x, group)
        want = sum(x - 100 * rank + 100 * r for r in range(n))
    else:
        got = comm.ppermute(x, group, 1).wait()
        want = x - 100 * rank + 100 * ((rank - 1) % n)
    return bool(got.device == dev and torch.equal(got, want))


def probe(op: str, backend: str, device: str, timeout: float = 60.0) -> str:
    from ..parallel import comm

    world = 1 if backend == "nccl" else 2
    try:
        oks = comm.launch(run_op, world, op, device, backend=backend,
                          device="cuda" if backend == "nccl" or device == "cuda" else "cpu",
                          timeout=timeout)
    except (RuntimeError, TimeoutError) as e:
        return "fails: " + str(e).strip().splitlines()[-1][:160]
    return "ok" if all(oks) else "wrong result"


def main() -> int:
    import torch

    from ..parallel import comm

    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    cases = [(op, "gloo", dev) for op in OPS for dev in ("cpu", "cuda")]
    cases += [(op, "nccl", "cuda") for op in OPS]
    with ThreadPoolExecutor(len(cases)) as pool:
        results = list(pool.map(lambda c: probe(*c), cases))
    staged = []
    for (op, backend, dev), res in zip(cases, results):
        print(f"{backend:5s} {op:13s} {dev:5s} tensors: {res}")
        if dev == "cuda" and res != "ok":
            staged.append((backend, op))
    print(f"to stage through host memory: {sorted(staged)}; comm.STAGED now "
          f"{sorted(comm.STAGED)}")
    return 0 if all(r == "ok" for (_, b, d), r in zip(cases, results) if d == "cpu") else 1


if __name__ == "__main__":
    sys.exit(main())

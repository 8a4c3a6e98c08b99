"""Seconds nvcc takes for each of the port's CUDA sources, with the build's
own flags, all started together (as `chip_smoke.py` phase 2 starts them).

    python3 -m voltrix_spmm_tpu_torch.tools.nvcc_times [--csrc DIR] [SOURCE ...]

SOURCE names files of DIR (default: the package's csrc/; every .cu there when
none is named); --csrc may point at another checkout's csrc/ to time its
sources beside these in one call. Each library is written to a temporary
directory and removed; nothing is cached. Prints one line a source, then a
JSON object {source: seconds}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from ..jit.compiler import CSRC_DIR, NVCC_FLAGS, get_nvcc


def nvcc_seconds(csrc: str, source: str, out: str) -> tuple[float, int, str]:
    """(seconds, return code, nvcc's errors) of building csrc/`source` into
    the library `out`."""
    t0 = time.perf_counter()
    r = subprocess.run([get_nvcc(), *NVCC_FLAGS, f"-I{csrc}", "-o", out,
                        os.path.join(csrc, source)], capture_output=True, text=True)
    return time.perf_counter() - t0, r.returncode, r.stderr[-2000:] if r.returncode else ""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=None,
                    help="a csrc/ directory (repeatable; default the package's)")
    ap.add_argument("sources", nargs="*")
    args = ap.parse_args(argv)
    dirs = [os.path.abspath(d) for d in (args.csrc or [CSRC_DIR])]
    jobs = [(d, s) for d in dirs
            for s in (args.sources or sorted(f for f in os.listdir(d) if f.endswith(".cu")))]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(lambda i: nvcc_seconds(*jobs[i], os.path.join(tmp, f"{i}.so")),
                                range(len(jobs))))
    times = {}
    for (d, s), (secs, rc, err) in zip(jobs, results):
        print(f"{d}/{s}: {secs:.2f} s rc {rc}{(': ' + err) if err else ''}")
        times[f"{d}/{s}"] = round(secs, 2)
    print(json.dumps(times))
    if any(rc for _, rc, _ in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

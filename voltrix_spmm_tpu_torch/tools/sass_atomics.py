"""The atomic instructions in the SASS of each of the port's kernel
libraries: which atomics the compiler made native and which it turned into
compare-and-swap loops (ATOMS.CAST.SPIN for a shared float add on sm_90).

    python3 -m voltrix_spmm_tpu_torch.tools.sass_atomics

Needs nvcc and cuobjdump (the CUDA toolkit); builds the libraries first.
"""

from __future__ import annotations

import collections
import os
import shutil
import subprocess

from ..jit.compiler import CSRC_DIR, build, get_nvcc


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or os.path.join(os.path.dirname(get_nvcc()), "cuobjdump")
    if not os.path.isfile(path):
        raise SystemExit("sass_atomics needs cuobjdump from the CUDA toolkit")
    return path


def atomics(fname: str) -> collections.Counter:
    """The atomic and reduction instructions in the SASS of the library
    built from csrc/`fname`, by opcode."""
    lib = build(fname[:-3], [fname]).path
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    return collections.Counter(
        tok.rstrip(";") for line in sass.splitlines() for tok in line.split()
        if tok.startswith(("ATOM", "RED"))
    )


def main() -> None:
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith(".cu"):
            ops = atomics(fname)
            print(f"{fname}: {dict(sorted(ops.items())) or 'no atomics'}")


if __name__ == "__main__":
    main()

"""nvcc build of the port's CUDA sources with a content-addressed cache
(counterpart of voltrix_spmm_tpu/jit/compiler.py).

Each library is compiled from `csrc/` into a shared library with a plain
C interface and loaded with ctypes; no PyTorch header is compiled, which
keeps a build to seconds. The cache key hashes the sources, the nvcc
binary and version, and the flags. The library is written to a temporary
file and moved into place with `os.replace`, so two processes building
at once never load a partial file. A machine without nvcc gets a clear
error: there is no prebuilt or plain fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

from ..project import const
from .runtime import Runtime

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

runtime_cache: dict[str, Runtime] = {}


def get_nvcc() -> str:
    override = os.environ.get(const.NVCC_FLAG)
    if override:
        return override
    path = shutil.which("nvcc")
    if path:
        return path
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use (put nvcc on PATH, or set CUDA_HOME or "
        f"${const.NVCC_FLAG}); there is no prebuilt or plain fallback"
    )


def get_build_dir() -> str:
    return os.environ.get(const.BUILD_DIR_FLAG) or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "kernels"
    )


def _source_hash(md5) -> None:
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh")):
            md5.update(fname.encode())
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                md5.update(f.read())


def build(name: str, sources: list[str]) -> Runtime:
    """Compile `sources` (file names under csrc/) into lib<name>.so, or
    reuse the cached build; return its Runtime."""
    nvcc = get_nvcc()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    md5 = hashlib.md5()
    for part in (name, nvcc, version, " ".join(NVCC_FLAGS)):
        md5.update(part.encode() + b"$$")
    _source_hash(md5)
    out_dir = os.path.join(get_build_dir(), f"{name}.{md5.hexdigest()[:16]}")
    so_path = os.path.join(out_dir, f"lib{name}.so")
    if so_path in runtime_cache:
        return runtime_cache[so_path]

    if not os.path.isfile(so_path):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        cmd = [
            nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", tmp,
            *(os.path.join(CSRC_DIR, s) for s in sources),
        ]
        verbose = os.environ.get(const.PRINT_NVCC_COMMAND_FLAG, "0") == "1"
        if verbose:
            print("voltrix_torch nvcc:", " ".join(cmd), flush=True)
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc build of {name} failed:\n{' '.join(cmd)}\n"
                f"{result.stdout}{result.stderr}"
            )
        if verbose and (result.stdout or result.stderr):
            print(result.stdout + result.stderr, flush=True)
        os.replace(tmp, so_path)

    rt = Runtime(so_path)
    runtime_cache[so_path] = rt
    return rt

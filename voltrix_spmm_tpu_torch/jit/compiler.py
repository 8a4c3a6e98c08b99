"""nvcc build of the port's CUDA sources, and g++ build of its host
C++ (counterpart of voltrix_spmm_tpu/jit/compiler.py), each with a
content-addressed cache.

Each library is compiled from `csrc/` into a shared library with a plain
C interface and loaded with ctypes; no PyTorch header is compiled, which
keeps a build to seconds. The cache key hashes the sources, the nvcc
binary and version, and the flags. The library is written to a temporary
file and moved into place with `os.replace`, so two processes building
at once never load a partial file. A machine without nvcc gets a clear
error: there is no prebuilt or plain fallback.

`build_host` compiles a host translation unit (jit/template.py:generate
around csrc/voltrix_preprocess.hpp) with g++ -O3 -fopenmp into the same
build directory, with the same cache and the same `os.replace`; a
machine without a C++ compiler gets a clear error.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

from ..project import const
from .runtime import HostRuntime, Runtime

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-fopenmp")

runtime_cache: dict[str, Runtime | HostRuntime] = {}


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


def get_cxx() -> str:
    override = os.environ.get(const.CXX_FLAG)
    if override:
        if not shutil.which(override):
            raise RuntimeError(f"${const.CXX_FLAG}={override} is not an executable C++ compiler")
        return override
    for cand in ("g++", "c++", "clang++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler found: the native preprocess is built from "
        f"{CSRC_DIR} at first use (put g++ on PATH or set ${const.CXX_FLAG})"
    )


def _source_hash(md5, suffixes=(".cu", ".cuh")) -> None:
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith(suffixes):
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
        _compile([nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}"],
                 [os.path.join(CSRC_DIR, s) for s in sources], so_path, f"nvcc build of {name}")

    rt = Runtime(so_path)
    runtime_cache[so_path] = rt
    return rt


def _compile(cmd: list[str], sources: list[str], so_path: str, what: str) -> None:
    """Run the compiler command `cmd` on `sources` with its output in a
    temporary file beside `so_path`, then move that into place, so a process building at
    the same time never loads a partial library; raise with the compiler's
    output if it fails. VOLTRIX_TORCH_PRINT_NVCC_COMMAND=1 prints the command
    and the compiler's output (nvcc's: ptxas registers, shared memory,
    spills)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(so_path), suffix=".so.tmp")
    os.close(fd)
    cmd = [*cmd, "-o", tmp, *sources]
    verbose = os.environ.get(const.PRINT_NVCC_COMMAND_FLAG, "0") == "1"
    if verbose:
        print(f"voltrix_torch {what}:", " ".join(cmd), flush=True)
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{what} failed:\n{' '.join(cmd)}\n{result.stdout}{result.stderr}")
    if verbose and (result.stdout or result.stderr):
        print(result.stdout + result.stderr, flush=True)
    os.replace(tmp, so_path)


def build_host(name: str, arg_defs, code: str) -> HostRuntime:
    """Compile `code` (a translation unit from `jit.template.generate`,
    including headers of csrc/) with the host C++ compiler into
    libhost_<name>.so, or reuse the cached build; return its HostRuntime.
    The cache key hashes the code, csrc's C++ headers, the compiler and its
    version, and the flags."""
    cxx = get_cxx()
    version = subprocess.run(
        [cxx, "--version"], capture_output=True, text=True, check=True
    ).stdout
    md5 = hashlib.md5()
    for part in (name, code, cxx, version, " ".join(CXX_FLAGS)):
        md5.update(part.encode() + b"$$")
    _source_hash(md5, (".hpp", ".h"))
    out_dir = os.path.join(get_build_dir(), f"host_{name}.{md5.hexdigest()[:16]}")
    so_path = os.path.join(out_dir, f"libhost_{name}.so")
    if so_path in runtime_cache:
        return runtime_cache[so_path]

    if not os.path.isfile(so_path):
        os.makedirs(out_dir, exist_ok=True)
        fd, src = tempfile.mkstemp(dir=out_dir, suffix=".cpp")
        with os.fdopen(fd, "w") as f:
            f.write(code)
        try:
            _compile([cxx, *CXX_FLAGS, f"-I{CSRC_DIR}"], [src], so_path, f"C++ build of {name}")
        finally:
            os.unlink(src)

    rt = HostRuntime(so_path, arg_defs)
    runtime_cache[so_path] = rt
    return rt

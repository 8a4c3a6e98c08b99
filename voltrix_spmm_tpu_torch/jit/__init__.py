from .compiler import CSRC_DIR, NVCC_FLAGS, build, get_build_dir, get_nvcc
from .runtime import Runtime

__all__ = ["CSRC_DIR", "NVCC_FLAGS", "build", "get_build_dir", "get_nvcc", "Runtime"]

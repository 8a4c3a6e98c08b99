from .compiler import (CSRC_DIR, CXX_FLAGS, NVCC_FLAGS, build, build_host, get_build_dir, get_cxx,
                       get_nvcc)
from .runtime import HostRuntime, Runtime
from .template import cpp_format, generate, map_cpp_type, map_ctype

__all__ = ["CSRC_DIR", "CXX_FLAGS", "NVCC_FLAGS", "build", "build_host", "get_build_dir", "get_cxx",
           "get_nvcc", "HostRuntime", "Runtime", "cpp_format", "generate", "map_cpp_type",
           "map_ctype"]

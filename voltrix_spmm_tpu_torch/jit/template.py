"""C++ code generation for the host builds (counterpart of
voltrix_spmm_tpu/jit/template.py): dtype -> C type maps, a brace-safe
`cpp_format`, and `generate`, which wraps a body in an ``extern "C" int
launch(...)`` function. The host library it builds (jit/compiler.py:
build_host) takes numpy arrays; the CUDA kernels have their own C entry
points in csrc/*.cu.
"""

from __future__ import annotations

import ctypes
from typing import Iterable

import numpy as np

# arg_def dtype -> (C parameter type, ctypes type)
_ARG_TYPES = {
    np.int32: ("int*", ctypes.c_void_p),
    np.uint32: ("unsigned int*", ctypes.c_void_p),
    np.int64: ("long long*", ctypes.c_void_p),
    np.float32: ("float*", ctypes.c_void_p),
    np.float64: ("double*", ctypes.c_void_p),
    np.uint8: ("unsigned char*", ctypes.c_void_p),
    int: ("long long", ctypes.c_int64),
    float: ("double", ctypes.c_double),
}


def map_ctype(dtype):
    """The ctypes type of an arg_def dtype."""
    if dtype not in _ARG_TYPES:
        raise TypeError(f"unsupported arg dtype {dtype!r}")
    return _ARG_TYPES[dtype][1]


def map_cpp_type(dtype) -> str:
    """The C parameter type of an arg_def dtype."""
    if dtype not in _ARG_TYPES:
        raise TypeError(f"unsupported arg dtype {dtype!r}")
    return _ARG_TYPES[dtype][0]


def cpp_format(template: str, keys: dict) -> str:
    """`{key}` substitution that leaves C++ braces alone (str.format would
    read them as fields)."""
    out = template
    for k, v in keys.items():
        out = out.replace("{" + k + "}", str(v))
    return out


def generate(includes: Iterable[str], arg_defs: Iterable[tuple[str, object]], body: str) -> str:
    """A translation unit with ``extern "C" int launch(...)`` around `body`.

    arg_defs: (name, dtype) pairs; arrays arrive as typed pointers, scalars
    by value. `body` sets ``__return_code`` (0 = ok), which launch returns.
    """
    lines = ["// generated by voltrix_spmm_tpu_torch.jit"]
    for inc in includes:
        lines.append(f"#include {inc}")
    lines.append("")
    params = [f"{map_cpp_type(dtype)} {name}" for name, dtype in arg_defs]
    lines.append('extern "C" int launch(' + ", ".join(params) + ") {")
    lines.append("  int __return_code = 0;")
    lines.append("  {")
    lines.append(body)
    lines.append("  }")
    lines.append("  return __return_code;")
    lines.append("}")
    return "\n".join(lines) + "\n"

"""Handles on built libraries (counterpart of
voltrix_spmm_tpu/jit/runtime.py): `Runtime` loads a CUDA kernel library
with ctypes at first use and hands out its C functions with declared
signatures; `HostRuntime` calls the ``launch`` function of a host
library built from `jit.template.generate`, checking each numpy argument
against its arg_def."""

from __future__ import annotations

import ctypes

import numpy as np

from .template import map_ctype


class Runtime:
    def __init__(self, path: str):
        self.path = path
        self._lib = None

    def function(self, name: str, argtypes, restype=ctypes.c_int):
        """The C function `name` with `argtypes` and `restype` declared, so
        ctypes neither cuts a pointer to 32 bits nor guesses the result."""
        if self._lib is None:
            self._lib = ctypes.CDLL(self.path)
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn


class HostRuntime:
    """``launch(*args) -> int`` of a host library: arrays must be
    C-contiguous numpy arrays of their arg_def dtype, scalars ints or
    floats; a mismatch raises TypeError before the call."""

    def __init__(self, path: str, arg_defs):
        self.path = path
        self.arg_defs = tuple(arg_defs)
        self._launch = None

    def __call__(self, *args) -> int:
        if self._launch is None:
            fn = ctypes.CDLL(self.path).launch
            fn.restype = ctypes.c_int
            fn.argtypes = [map_ctype(dtype) for _, dtype in self.arg_defs]
            self._launch = fn
        if len(args) != len(self.arg_defs):
            raise TypeError(f"expected {len(self.arg_defs)} args, got {len(args)}")
        cargs = []
        for arg, (name, dtype) in zip(args, self.arg_defs):
            if isinstance(dtype, type) and issubclass(dtype, np.generic):
                if not (isinstance(arg, np.ndarray) and arg.dtype == dtype
                        and arg.flags["C_CONTIGUOUS"]):
                    raise TypeError(f"{name}: expected a C-contiguous {np.dtype(dtype)} array")
                cargs.append(ctypes.c_void_p(arg.ctypes.data))
            elif dtype is int:
                if not isinstance(arg, (int, np.integer)):
                    raise TypeError(f"{name}: expected int")
                cargs.append(ctypes.c_int64(int(arg)))
            elif dtype is float:
                cargs.append(ctypes.c_double(float(arg)))
            else:
                raise TypeError(f"{name}: unsupported arg_def dtype {dtype!r}")
        return int(self._launch(*cargs))

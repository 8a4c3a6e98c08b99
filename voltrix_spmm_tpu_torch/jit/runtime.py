"""Handle on a built kernel library (counterpart of
voltrix_spmm_tpu/jit/runtime.py): loads the shared library with ctypes at
first use and hands out its C functions with declared signatures."""

from __future__ import annotations

import ctypes


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

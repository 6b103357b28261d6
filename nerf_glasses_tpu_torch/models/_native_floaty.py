"""ctypes bridge to the native floaty-removal core (native/floaty.cpp),
the same library the JAX package opens. Port of
nerf_glasses_tpu/models/_native_floaty.py.

Builds the shared library on first use (make -C native) and raises when
it cannot be built or loaded; models/floaty.py then takes the
numpy/scipy implementation and records why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnmr_native.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.remove_floaties_native.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.remove_floaties_native.restype = ctypes.c_int
    _lib = lib
    return lib


def remove_floaties(occ_linear: np.ndarray):
    """occ_linear: (8,128,128,128) -> (cleaned uint8 grid, n_clusters)."""
    lib = _load()
    src = np.ascontiguousarray(
        (np.asarray(occ_linear).reshape(8, 128, 128, 128) > 0)
        .astype(np.uint8))
    out = np.zeros_like(src)
    n = ctypes.c_int32(0)
    rc = lib.remove_floaties_native(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"remove_floaties_native failed: {rc}")
    return out, int(n.value)

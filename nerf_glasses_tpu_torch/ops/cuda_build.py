"""Build a CUDA source of csrc/ with nvcc into a shared library with a
plain C interface, once per hash of the source and flags, into `_build/`
at first use, and load it with ctypes.

The kernel modules (mesh_cuda, march_cuda) each build their own source
through `build_library`; building never happens at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's "
                           "CUDA kernels cannot be built")
    return path


def build_library(source: str, flags, build_dir: str = BUILD_DIR):
    """-> (ctypes.CDLL, nvcc's output, nvcc seconds; both empty / 0.0 when
    the library of this source and these flags was built before)."""
    with open(source, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    name = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(build_dir, f"{name}-{key[:16]}.so")
    log, seconds = "", 0.0
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, source],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(so), log, seconds


def declare(lib, signatures):
    """Set argtypes and restype of each (name, argtypes, restype)."""
    for name, args, res in signatures:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib

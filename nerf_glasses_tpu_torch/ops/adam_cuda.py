"""The trainer's Adam update: the CUDA kernel, its wrapper and its plain
PyTorch version.

- `adam` (kernel nmr_adam, csrc/adam.cu) is one Adam step of up to 8
  parameters in one launch, in place: the network's hash table and MLP
  matrices (the JAX package's adam_update, nerf_glasses_tpu/train/
  trainer.py:665, which XLA fuses; no Pallas kernel). Plain version:
  `adam_reference`, the trainer's former aten update.

The learning rate times the bias correction (`lr_corr`) changes every
step: the kernel reads it from a one-element f32 tensor on the device
when it runs, so that a launch captured in a CUDA graph serves every
step; the plain version reads it on the host. The kernel keeps the plain
version's elementwise order and rounds each operation on its own, as
aten does on the card: it is the card's plain version bit for bit (the
CPU's plain version takes MKL's sqrt, off by an ulp on some values: its
moments are the kernel's, its parameters differ there in the last
place). On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises. Each launch counts in
`launches["adam"]`. The kernel builds with nvcc for sm_90a at first use
(ops/cuda_build.py), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from nerf_glasses_tpu_torch.ops import cuda_build

_SOURCE = os.path.join(cuda_build.PKG, "csrc", "adam.cu")
NVCC_FLAGS = cuda_build.ARCH_FLAGS
MAX_ENTRIES = 8

launches = {"adam": 0}
_lib = None
build_log = ""
build_seconds = 0.0


class AdamParams(ctypes.Structure):
    """csrc/adam.cu's AdamParams."""
    _fields_ = [("n_entries", ctypes.c_int),
                ("b1", ctypes.c_float), ("c1", ctypes.c_float),
                ("b2", ctypes.c_float), ("c2", ctypes.c_float),
                ("eps", ctypes.c_float),
                ("l2", ctypes.c_float * MAX_ENTRIES),
                ("start", ctypes.c_longlong * (MAX_ENTRIES + 1)),
                ("p", ctypes.c_void_p * MAX_ENTRIES),
                ("g", ctypes.c_void_p * MAX_ENTRIES),
                ("m", ctypes.c_void_p * MAX_ENTRIES),
                ("v", ctypes.c_void_p * MAX_ENTRIES)]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    lib, build_log, build_seconds = cuda_build.build_library(_SOURCE,
                                                             NVCC_FLAGS)
    p = ctypes.c_void_p
    _lib = cuda_build.declare(lib, [("nmr_adam", [p, p, ctypes.c_int, p],
                                     ctypes.c_int)])
    return _lib


def constants(beta1: float, beta2: float, eps: float):
    """(b1, 1 - b1, b2, 1 - b2, eps) as the f32 values aten multiplies
    and adds by: each Python scalar (1 - b taken in double) cast to f32."""
    return tuple(float(np.float32(c)) for c in
                 (beta1, 1 - beta1, beta2, 1 - beta2, eps))


def adam_reference(params, grads, ms, vs, l2s, lr_corr: float, beta1: float,
                   beta2: float, eps: float):
    """One Adam step in place of each params[i] (f32) from grads[i], its
    moments ms[i], vs[i] and its l2 regularisation l2s[i] (0: none): g' =
    g + l2 p, m = b1 m + (1 - b1) g', v = b2 v + (1 - b2) g' g', p -=
    lr_corr m / (sqrt(v) + eps), each an aten operation in that order."""
    with torch.no_grad():
        for p, g, m, v, l2 in zip(params, grads, ms, vs, l2s):
            if l2:
                g = g + l2 * p
            m.copy_(beta1 * m + (1 - beta1) * g)
            v.copy_(beta2 * v + (1 - beta2) * g * g)
            p.sub_(lr_corr * m / (torch.sqrt(v) + eps))


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def adam(params, grads, ms, vs, l2s, lr_corr: torch.Tensor, beta1: float,
         beta2: float, eps: float):
    """adam_reference's step, lr_corr one f32 element on the parameters'
    device: on CUDA tensors one launch of nmr_adam for all entries (at
    most 8; each p, g, m, v f32 contiguous, of its parameter's shape),
    which reads lr_corr when it runs; on CPU tensors the plain version."""
    n = len(params)
    if not 1 <= n <= MAX_ENTRIES or not (len(grads) == len(ms) == len(vs)
                                        == len(l2s) == n):
        raise ValueError(f"adam: {n} parameters (1-{MAX_ENTRIES}), and as "
                         f"many gradients, moments and l2 factors")
    dev = params[0].device
    if (lr_corr.dtype != torch.float32 or lr_corr.numel() != 1
            or lr_corr.device != dev):
        raise ValueError(f"adam: lr_corr must be one float32 on {dev}")
    for name, ts in (("params", params), ("grads", grads), ("m", ms),
                     ("v", vs)):
        for t, p in zip(ts, params):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != p.shape
                    or (dev.type == "cuda" and not t.is_contiguous())):
                raise ValueError(f"adam: {name} must be float32 on {dev} of "
                                 f"their parameters' shapes (contiguous on "
                                 f"the card)")
    if dev.type == "cpu":
        adam_reference(params, grads, ms, vs, l2s, float(lr_corr), beta1,
                       beta2, eps)
        return
    if dev.type != "cuda":
        raise ValueError(f"adam: tensors must lie on the CPU or a CUDA "
                         f"device, got {dev}")
    b1, c1, b2, c2, e = constants(beta1, beta2, eps)
    P = AdamParams(n_entries=n, b1=b1, c1=c1, b2=b2, c2=c2, eps=e)
    start = 0
    for i, (p, g, m, v, l2) in enumerate(zip(params, grads, ms, vs, l2s)):
        P.l2[i] = float(np.float32(l2))
        P.start[i] = start
        start += p.numel()
        P.p[i], P.g[i], P.m[i], P.v[i] = (p.data_ptr(), g.data_ptr(),
                                          m.data_ptr(), v.data_ptr())
    P.start[n] = start
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = load_library().nmr_adam(
            ctypes.byref(P), lr_corr.data_ptr(), _sm_count(index),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nmr_adam launch failed: cudaError_t {err}")
    launches["adam"] += 1


def adam_work(params):
    """-> (flops, bytes): ~12 operations an element; p, g, m, v read and
    p, m, v written once (28 bytes an element)."""
    n = sum(p.numel() for p in params)
    return 12 * n, 28 * n

"""Time/step EMA meters (reference: Ema, ngp_common.cuh:401-446) and the
device's memory counters. Port of nerf_glasses_tpu/utils/meters.py."""

from __future__ import annotations

import time

import torch


class Ema:
    """Exponentially-decayed meter; half_life in ms (time mode) or steps."""

    TIME = "time"
    STEP = "step"

    def __init__(self, mode: str = "time", half_life: float = 1000.0):
        self.mode = mode
        self.decay = 0.5 ** (1.0 / half_life)
        self._t0 = time.monotonic()
        self._last_progress = 0
        self._val = 0.0
        self._ema = 0.0

    def _progress(self):
        if self.mode == Ema.TIME:
            return int((time.monotonic() - self._t0) * 1000.0)
        return self._last_progress + 1

    def update(self, val: float):
        cur = self._progress()
        elapsed = cur - self._last_progress
        self._last_progress = cur
        d = self.decay ** elapsed
        self._val = val
        self._ema = d * self._ema + (1.0 - d) * val

    def set(self, val: float):
        self._last_progress = self._progress()
        self._val = self._ema = val

    @property
    def val(self) -> float:
        return self._val

    @property
    def ema_val(self) -> float:
        return self._ema


def device_memory_stats(device="cuda") -> dict:
    """Memory of a torch device -> {"bytes_in_use", "bytes_limit",
    "peak_bytes_in_use", "available": bool}: the cudaMemGetInfo/VRAM
    panel of the reference (nerf_mesh_renderer.cu:852-873).

    On a CUDA device bytes_in_use and the peak are PyTorch's allocator
    counters and bytes_limit is the card's total memory. The CPU has no
    such allocator: `available` is False and the byte fields are 0."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"available": False, "bytes_in_use": 0, "bytes_limit": 0,
                "peak_bytes_in_use": 0}
    _, total = torch.cuda.mem_get_info(device)
    return {"available": True,
            "bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device))}

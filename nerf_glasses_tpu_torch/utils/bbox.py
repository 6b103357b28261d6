"""Axis-aligned bounding box (host-side numpy) and its tensor helpers.

Port of nerf_glasses_tpu/utils/bbox.py (reference BoundingBox,
src/ngp/bounding_box.cuh:22-173).
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)


class BoundingBox:
    def __init__(self, a=None, b=None):
        if a is None:
            self.min = np.full(3, np.inf, np.float32)
            self.max = np.full(3, -np.inf, np.float32)
        else:
            self.min = np.asarray(a, np.float32).copy()
            self.max = np.asarray(b, np.float32).copy()

    def __repr__(self):
        return f"BoundingBox(min={self.min.tolist()}, max={self.max.tolist()})"

    def copy(self) -> "BoundingBox":
        return BoundingBox(self.min, self.max)

    def is_empty(self) -> bool:
        return bool(np.any(self.max < self.min))

    def center(self) -> np.ndarray:
        return 0.5 * (self.min + self.max)

    def diag(self) -> np.ndarray:
        return self.max - self.min

    def relative_pos(self, pos) -> np.ndarray:
        return (np.asarray(pos) - self.min) / self.diag()

    def enlarge(self, other):
        """Grow to hold another box or a point."""
        if isinstance(other, BoundingBox):
            lo, hi = other.min, other.max
        else:
            lo = hi = np.asarray(other, np.float32)
        self.min = np.minimum(self.min, lo)
        self.max = np.maximum(self.max, hi)

    def inflate(self, amount: float):
        self.min = self.min - amount
        self.max = self.max + amount

    def intersection(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(np.maximum(self.min, other.min),
                           np.minimum(self.max, other.max))

    def intersects(self, other: "BoundingBox") -> bool:
        return not self.intersection(other).is_empty()

    def contains(self, p) -> bool:
        p = np.asarray(p)
        return bool(np.all(p >= self.min) and np.all(p <= self.max))

    def ray_intersect(self, o, d) -> np.ndarray:
        """Slab test in float64 -> (tmin, tmax) float32; (FLT_MAX,
        FLT_MAX) on a miss."""
        o = np.asarray(o, np.float64)
        d = np.asarray(d, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (self.min - o) / d
            t1 = (self.max - o) / d
        tmin = np.nanmax(np.minimum(t0, t1))
        tmax = np.nanmin(np.maximum(t0, t1))
        if tmin > tmax:
            return np.array([FLT_MAX, FLT_MAX], np.float32)
        return np.array([tmin, tmax], np.float32)


def ray_intersect_aabb(o: torch.Tensor, d: torch.Tensor, box_min, box_max):
    """Vectorized slab test. o, d (..., 3); box_min/max (3,) tensors ->
    (tmin, tmax) each (...,); misses return (FLT_MAX, FLT_MAX)."""
    inv = 1.0 / d  # inf where d == 0, IEEE division as in the reference
    t0 = (box_min - o) * inv
    t1 = (box_max - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    miss = tmin > tmax
    return (torch.where(miss, FLT_MAX, tmin),
            torch.where(miss, FLT_MAX, tmax))


def contains_aabb(p: torch.Tensor, box_min, box_max) -> torch.Tensor:
    return torch.all((p >= box_min) & (p <= box_max), dim=-1)

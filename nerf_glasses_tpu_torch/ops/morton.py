"""3D Morton (Z-order) codes for the snapshot's density-grid layout.

Port of nerf_glasses_tpu/ops/morton.py (tiny-cuda-nn morton3D), host
numpy only: the grid is Morton-ordered only at the snapshot boundary.
"""

from __future__ import annotations

import numpy as np


def _expand_bits(v):
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton3d(x, y, z):
    """Interleave bits: result bit 3i = x bit i, 3i+1 = y, 3i+2 = z."""
    x, y, z = (np.asarray(a).astype(np.uint32) for a in (x, y, z))
    return _expand_bits(x) | (_expand_bits(y) << 1) | (_expand_bits(z) << 2)


def _compact_bits(v):
    v = v & 0x9249249
    v = (v ^ (v >> 2)) & 0x30C30C3
    v = (v ^ (v >> 4)) & 0x300F00F
    v = (v ^ (v >> 8)) & 0x30000FF
    v = (v ^ (v >> 16)) & 0x3FF
    return v


def morton3d_invert(v):
    """Every third bit from bit 0 (tcnn morton3D_invert)."""
    return _compact_bits(np.asarray(v).astype(np.uint32))


def morton_order_lut(res: int = 128) -> np.ndarray:
    """morton_idx[x + res*(y + res*z)] for a res^3 grid."""
    c = np.arange(res, dtype=np.uint32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    out = np.empty(res ** 3, dtype=np.uint32)
    out[(x + res * (y + res * z)).reshape(-1)] = morton3d(x, y, z).reshape(-1)
    return out


def morton_to_linear_lut(res: int = 128) -> np.ndarray:
    """linear_idx[morton] for a res^3 grid (the inverse permutation)."""
    lut = morton_order_lut(res)
    inv = np.empty_like(lut)
    inv[lut] = np.arange(res ** 3, dtype=np.uint32)
    return inv

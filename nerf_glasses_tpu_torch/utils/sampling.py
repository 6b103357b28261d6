"""Low-discrepancy sequences and sampling helpers.

Port of nerf_glasses_tpu/utils/sampling.py, numpy only (the reference's
random_val.cuh: halton/sobol, ld_random_pixel_offset, disk and
hemisphere sampling).
"""

from __future__ import annotations

import numpy as np


def halton(index, base: int):
    """Radical inverse of `index` in `base` (vectorized)."""
    index = np.asarray(index, np.int64)
    f = np.ones(index.shape)
    r = np.zeros(index.shape)
    denom = np.full(index.shape, float(base))
    i = index.copy()
    for _ in range(32):
        active = i > 0
        if not active.any():
            break
        digit = i % base
        r = np.where(active, r + digit / denom, r)
        denom = np.where(active, denom * base, denom)
        i = i // base
    return r


def halton23(index):
    """(halton base 2, halton base 3) pairs."""
    return np.stack([halton(index, 2), halton(index, 3)], axis=-1)


def sobol2d(index):
    """First two dimensions of the Sobol sequence (direction numbers for
    dim 2 per the standard construction)."""
    index = np.asarray(index, np.uint32)
    # dim 1: van der Corput (bit reversal)
    x = index.copy()
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = (x << 16) | (x >> 16)
    # dim 2: Sobol direction numbers v_k = of the primitive polynomial x+1
    v = np.uint32(1 << 31)
    y = np.zeros_like(index)
    idx = index.copy()
    vk = np.full(index.shape, v, np.uint32)
    for _ in range(32):
        bit = idx & 1
        y = np.where(bit.astype(bool), y ^ vk, y)
        vk = vk ^ (vk >> 1)
        idx >>= 1
    return np.stack([x, y], -1).astype(np.float64) / 4294967296.0


def ld_random_pixel_offset(spp: int, seed: int = 0xDEADBEEF):
    """Scrambled-Sobol pixel offset in [0,1)^2
    (random_val.cuh:322-328: 0.5 - s(0) + s(spp), fractional)."""
    s0 = sobol2d(np.asarray([0]))[0]
    si = sobol2d(np.asarray([spp]))[0]
    off = 0.5 - s0 + si
    return off - np.floor(off)


def square2disk_shirley(xy):
    """Concentric square->disk mapping (Shirley), xy in [-1,1]^2."""
    xy = np.asarray(xy, np.float64)
    x, y = xy[..., 0], xy[..., 1]
    r = np.where(np.abs(x) > np.abs(y), x, y)
    safe_x = np.where(x == 0, 1.0, x)
    safe_y = np.where(y == 0, 1.0, y)
    phi = np.where(np.abs(x) > np.abs(y),
                   (np.pi / 4) * (y / safe_x),
                   (np.pi / 2) - (np.pi / 4) * (x / safe_y))
    phi = np.where((x == 0) & (y == 0), 0.0, phi)
    return np.stack([r * np.cos(phi), r * np.sin(phi)], -1)


def cosine_hemisphere(uv):
    """Cosine-weighted hemisphere direction from uniform uv in [0,1)^2."""
    uv = np.asarray(uv, np.float64)
    disk = square2disk_shirley(uv * 2.0 - 1.0)
    z = np.sqrt(np.maximum(0.0, 1.0 - np.sum(disk * disk, -1)))
    return np.concatenate([disk, z[..., None]], -1)

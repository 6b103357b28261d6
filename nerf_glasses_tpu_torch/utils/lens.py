"""Lens models: f-theta (fisheye) undistortion, lat-long, OpenCV radial.

Port of nerf_glasses_tpu/utils/lens.py, numpy only (the reference's
ngp_common.cuh:277-299 f_theta_undistortion / latlong_to_dir, and
upstream instant-ngp's iterative_opencv_lens_undistortion). The traced
forms the frame uses are in ops/raymarch.py; the trainer's envmap
sampler follows dir_to_latlong's convention.
"""

from __future__ import annotations

import numpy as np


def f_theta_undistortion(uv: np.ndarray, params,
                         error_direction=(1000.0, 0.0, 0.0)) -> np.ndarray:
    """uv: (..., 2) screen offsets; params: (r0..r4, width, height).
    Returns direction vectors (..., 3); `error_direction` where the
    polynomial has no stable solution."""
    uv = np.asarray(uv, np.float64)
    p = np.asarray(params, np.float64)
    xpix = uv[..., 0] * p[5]
    ypix = uv[..., 1] * p[6]
    norm = np.sqrt(xpix * xpix + ypix * ypix)
    alpha = p[0] + norm * (p[1] + norm * (p[2] + norm * (p[3] + norm * p[4])))
    sin_a = np.sin(alpha)
    cos_a = np.cos(alpha)
    bad = (cos_a <= np.finfo(np.float32).tiny) | (norm == 0.0)
    safe_norm = np.where(norm == 0, 1.0, norm)
    s = sin_a / safe_norm
    out = np.stack([s * xpix, s * ypix, cos_a], axis=-1)
    err = np.broadcast_to(np.asarray(error_direction, np.float64), out.shape)
    return np.where(bad[..., None], err, out).astype(np.float32)


def latlong_to_dir(uv: np.ndarray) -> np.ndarray:
    """uv (..., 2) in [0,1] -> unit direction (lat-long panorama)."""
    uv = np.asarray(uv, np.float64)
    theta = (uv[..., 1] - 0.5) * np.pi
    phi = (uv[..., 0] - 0.5) * np.pi * 2.0
    ct = np.cos(theta)
    return np.stack([np.sin(phi) * ct, np.sin(theta),
                     np.cos(phi) * ct], axis=-1).astype(np.float32)


def dir_to_latlong(d: np.ndarray) -> np.ndarray:
    """Inverse of latlong_to_dir: unit dirs (..., 3) -> uv in [0,1]."""
    d = np.asarray(d, np.float64)
    theta = np.arcsin(np.clip(d[..., 1], -1.0, 1.0))
    phi = np.arctan2(d[..., 0], d[..., 2])
    return np.stack([phi / (2 * np.pi) + 0.5, theta / np.pi + 0.5],
                    axis=-1).astype(np.float32)


def opencv_lens_undistortion(x, y, k1, k2, p1, p2, iterations: int = 10):
    """Iteratively invert the OpenCV radial+tangential distortion model."""
    xd = np.asarray(x, np.float64)
    yd = np.asarray(y, np.float64)
    xu, yu = xd.copy(), yd.copy()
    for _ in range(iterations):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu = (xd - dx) / radial
        yu = (yd - dy) / radial
    return xu.astype(np.float32), yu.astype(np.float32)

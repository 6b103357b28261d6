"""Spherical-harmonics direction encoding, degree <= 4.

Port of nerf_glasses_tpu/ops/sh.py (tiny-cuda-nn
SphericalHarmonicsEncoding, encodings/spherical_harmonics.h:60-160):
directions arrive warped to [0, 1] and are unwarped here.
"""

from __future__ import annotations

import torch


def sh_encode(dirs01: torch.Tensor, degree: int = 4,
              padded_width: int = 16) -> torch.Tensor:
    """dirs01 (N, 3) warped to [0, 1] -> (N, padded_width)."""
    if degree > 4:
        raise ValueError(f"SH degree {degree} > 4 is not supported")
    x = dirs01[..., 0] * 2.0 - 1.0
    y = dirs01[..., 1] * 2.0 - 1.0
    z = dirs01[..., 2] * 2.0 - 1.0
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.ones_like(x) * 0.28209479177387814]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 3:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * x2 - 0.54627421529603959 * y2]
    if degree >= 4:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    feats = torch.stack(out, dim=-1)
    n = feats.shape[-1]
    if n < padded_width:
        # tcnn's SH kernel sets padding features to ONE
        # (spherical_harmonics.h:55-61), unlike the grid encoding's zeros
        pad = torch.ones(feats.shape[:-1] + (padded_width - n,),
                         dtype=feats.dtype, device=feats.device)
        feats = torch.cat([feats, pad], dim=-1)
    return feats

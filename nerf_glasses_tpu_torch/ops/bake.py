"""Baked density and feature grids for the fast path.

Port of nerf_glasses_tpu/ops/bake.py. Baking evaluates the density
network once at the cell centres of an R^3 grid over the unit cube; at
render time sigma is one trilinear lookup into that grid and, with
features, the colour MLP reads the baked 16-wide density-MLP output
instead of hash encode + density MLP. Scenes with aabb_scale > 1 bake one
such grid per cascade (`bake_grids_cascades`), cascade c over the cube of
side 2^c centred at 0.5 that occupancy level c covers, and the march
reads the grid of each sample's mip (`sample_baked_sigma_mip`,
`sample_feat_grid_mip`).

Layout. The JAX package packs sigma into a brick table (pack_sigma_bricks:
5x5x5 samples in 125 of 128 lanes, one 512-byte row per sample), a TPU
gather layout that costs twice the memory of the grid. A GPU gathers 4-byte
words natively, so the port keeps the dense (R, R, R) float32 grid [z, y, x]
and reads the 8 corners of each sample directly (`sample_baked_sigma`, the
reference's dense sampler), with the brick sampler's rules: positions
clipped to [0, 1], base corner i0 clipped to R - 2. The cascades' grids
are stacked, (n_casc, R, R, R) and (n_casc * Rf^3, 16), and indexed in
int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerf_glasses_tpu_torch.ops.network import (NerfNetwork,
                                                apply_density_activation)

LOG_SIGMA_PAD = -20.0   # raw density of empty cells in a log-space bake:
                        # exp(-20) ~ 2e-9 keeps the baked grid ~zero in
                        # empty space, and the ramp toward occupied raws
                        # (~[-5, 10]) stays well conditioned for trilerp


def _occ_mask(occ: torch.Tensor, R: int, level: int = 0) -> torch.Tensor:
    """(8, G, G, G) or (G, G, G) occupancy -> (R, R, R) bool mask of the
    1-voxel-dilated occupied region, nearest-neighbour resampled, on the
    occupancy's device. The dilation keeps boundary trilinear corners
    alive; like the reference (np.roll) it wraps at the grid's faces."""
    m = (occ[level] if occ.dim() == 4 else occ) > 0
    for axis in range(3):
        m = m | torch.roll(m, 1, axis) | torch.roll(m, -1, axis)
    G = m.shape[0]
    i = torch.clamp(torch.arange(R, device=m.device) * G // R, max=G - 1)
    return m[i][:, i][:, :, i]


def bake_grids(net: NerfNetwork, resolution: int = 256, batch: int = 1 << 20,
               occ: Optional[torch.Tensor] = None, features: bool = False,
               log_space: bool = False, mip: int = 0, aabb=None,
               density_activation: Optional[str] = None):
    """Evaluate the density network at the cell centres of a
    resolution^3 grid over cascade `mip`'s cube (side 2^mip centred at
    0.5; the unit cube for mip 0) -> (sigma (R, R, R) float32 [z, y, x],
    feat ((R^3, 16) bfloat16 raw density-MLP outputs, or None)).

    Both come from one sweep, with the density MLP in bfloat16 as
    `density_raw` defaults to. Given `occ`, the network runs only inside
    the 1-voxel-dilated occupied region; elsewhere sigma is 0 (or
    LOG_SIGMA_PAD) and the features are 0: the network emits junk density
    in space the occupancy grid culls, which the fast path would otherwise
    composite as fog. log_space=True stores raw density clamped at 30 (so
    exp after interpolation cannot overflow); the sampler's caller applies
    the activation after the trilinear lookup. The mask is occupancy
    level `mip`; `aabb` ((min, max) of the training box) maps the raw
    cell centres into the network's [0, 1] input (the identity for the
    unit cube). `density_activation` defaults to the network config's.
    Everything stays on the network's device."""
    R = resolution
    dev = net.grid.device
    act = density_activation or net.config.density_activation
    if occ is None:
        idx = torch.arange(R * R * R, device=dev)
    else:
        idx = torch.nonzero(
            _occ_mask(occ.to(dev), R, mip).reshape(-1)).squeeze(1)
    # cell centres in raw coordinates, as the reference computes them
    gd = ((torch.arange(R, dtype=torch.float32, device=dev) + 0.5) / R
          - 0.5) * float(1 << mip) + 0.5
    if aabb is not None:
        lo = torch.as_tensor(np.asarray(aabb[0], np.float32), device=dev)
        extent = torch.as_tensor(np.asarray(aabb[1], np.float32),
                                 device=dev) - lo
    fill = LOG_SIGMA_PAD if log_space else 0.0
    sigma = torch.full((R * R * R,), fill, dtype=torch.float32, device=dev)
    feat = None
    for s in range(0, idx.shape[0], batch):
        sel = idx[s:s + batch]
        iz = sel // (R * R)
        iy = sel // R % R
        ix = sel % R
        pos = torch.stack([gd[ix], gd[iy], gd[iz]], -1)
        if aabb is not None:
            pos = (pos - lo) / extent
        d_out = net.density_raw(pos)
        raw = d_out[:, 0]
        sigma[sel] = (torch.clamp(raw, max=30.0) if log_space
                      else apply_density_activation(raw, act))
        if features:
            if feat is None:
                feat = torch.zeros((R * R * R, d_out.shape[1]),
                                   dtype=torch.bfloat16, device=dev)
            feat[sel] = d_out.to(torch.bfloat16)
    if features and feat is None:     # nothing occupied
        feat = torch.zeros((R * R * R, 16), dtype=torch.bfloat16, device=dev)
    return sigma.reshape(R, R, R), feat


def bake_density_grid(net: NerfNetwork, resolution: int = 256,
                      batch: Optional[int] = None,
                      occ: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Activated density at the cell centres -> (R, R, R) [z, y, x]; see
    bake_grids."""
    kw = {} if batch is None else {"batch": batch}
    return bake_grids(net, resolution, occ=occ, **kw)[0]


def bake_grids_cascades(net: NerfNetwork, resolution: int = 256,
                        occ: Optional[torch.Tensor] = None,
                        log_space: bool = True, aabb=None,
                        features: bool = False,
                        feat_resolution: Optional[int] = None,
                        density_activation: Optional[str] = None):
    """One bake_grids sweep per cascade of an aabb_scale > 1 scene ->
    (sigma (n_casc, R, R, R) float32, feat ((n_casc * Rf^3, 16) bfloat16,
    cascade c's rows at c * Rf^3, or None). feat_resolution defaults to
    min(resolution, 256)."""
    n_casc = net.config.max_cascade + 1
    R = resolution
    Rf = min(R, 256) if feat_resolution is None else feat_resolution
    dev = net.grid.device
    kw = dict(occ=occ, aabb=aabb, density_activation=density_activation)
    sigma = torch.empty((n_casc, R, R, R), dtype=torch.float32, device=dev)
    feat = (torch.empty((n_casc * Rf ** 3, 16), dtype=torch.bfloat16,
                        device=dev) if features else None)
    for c in range(n_casc):
        sigma[c], f = bake_grids(net, R, features=features and Rf == R,
                                 log_space=log_space, mip=c, **kw)
        if features and Rf != R:
            _, f = bake_grids(net, Rf, features=True, mip=c, **kw)
        if features:
            feat[c * Rf ** 3:(c + 1) * Rf ** 3] = f
    return sigma, feat


def _trilinear_setup(pos01: torch.Tensor, R: int):
    """pos01 (..., 3) -> (corner flat indices (..., 8) [z, y, x] ravel,
    fractions (..., 3)) with the reference's clip rules."""
    p = torch.clamp(pos01, 0.0, 1.0) * R - 0.5
    i0 = torch.clamp(torch.floor(p).long(), 0, R - 2)
    f = torch.clamp(p - i0, 0.0, 1.0)
    base = (i0[..., 2] * R + i0[..., 1]) * R + i0[..., 0]
    off = torch.tensor([(dz * R + dy) * R + dx for dz in (0, 1)
                        for dy in (0, 1) for dx in (0, 1)], device=p.device)
    return base[..., None] + off, f


def _lerp8(c, fx, fy, fz):
    """The 8 corners c (dz, dy, dx order), fractions broadcastable to
    them -> the reference's lerp chain: x, then y, then z."""
    c00 = c[0] * (1 - fx) + c[1] * fx
    c10 = c[2] * (1 - fx) + c[3] * fx
    c01 = c[4] * (1 - fx) + c[5] * fx
    c11 = c[6] * (1 - fx) + c[7] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_baked_sigma(sigma: torch.Tensor, pos01: torch.Tensor
                       ) -> torch.Tensor:
    """Trilinear lookup into a dense (R, R, R) grid: pos01 (..., 3) in
    [0, 1] -> (...)."""
    idx, f = _trilinear_setup(pos01, sigma.shape[0])
    return _lerp8(sigma.reshape(-1)[idx].unbind(-1), *f.unbind(-1))


def sample_feat_grid(feat: torch.Tensor, pos01: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup into a bake_grids feature table: feat (R^3, C)
    [z, y, x ravelled], pos01 (N, 3) in [0, 1] -> (N, C) float32."""
    idx, f = _trilinear_setup(pos01, round(feat.shape[0] ** (1.0 / 3.0)))
    return _lerp8(feat[idx].float().unbind(1), *f[:, :, None].unbind(1))


def _cascade_local(pos_raw: torch.Tensor, mip: torch.Tensor, n_casc: int):
    """Raw marching positions (..., 3) and their mips (...,) -> (positions
    in the mip's own [0, 1] cube, q = (p - 0.5) * 2^-mip + 0.5 as
    occupied_at maps them; the mip as int64 clamped to the pyramid)."""
    mip = mip.long().clamp(0, n_casc - 1)
    return (pos_raw - 0.5) * torch.exp2(-mip.float())[..., None] + 0.5, mip


def sample_baked_sigma_mip(sigma: torch.Tensor, pos_raw: torch.Tensor,
                           mip: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup into a bake_grids_cascades pyramid (n_casc, R, R,
    R): pos_raw (..., 3) raw marching coordinates, mip (...,) -> (...)."""
    R = sigma.shape[1]
    q, mip = _cascade_local(pos_raw, mip, sigma.shape[0])
    idx, f = _trilinear_setup(q, R)
    idx = idx + (mip * R ** 3)[..., None]
    return _lerp8(sigma.reshape(-1)[idx].unbind(-1), *f.unbind(-1))


def sample_feat_grid_mip(feat: torch.Tensor, n_casc: int,
                         pos_raw: torch.Tensor, mip: torch.Tensor
                         ) -> torch.Tensor:
    """Trilinear lookup into a bake_grids_cascades feature pyramid: feat
    (n_casc * R^3, C), pos_raw (N, 3) raw marching coordinates, mip (N,)
    -> (N, C) float32."""
    R = round((feat.shape[0] // n_casc) ** (1.0 / 3.0))
    q, mip = _cascade_local(pos_raw, mip, n_casc)
    idx, f = _trilinear_setup(q, R)
    idx = idx + (mip * R ** 3)[:, None]
    return _lerp8(feat[idx].float().unbind(1), *f[:, :, None].unbind(1))

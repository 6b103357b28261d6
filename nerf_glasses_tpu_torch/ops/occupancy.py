"""Multi-mip occupancy grid: construction, lookup and DDA empty-space skip.

Port of nerf_glasses_tpu/ops/occupancy.py. The grid is a dense uint8
tensor in [mip, z, y, x] layout; Morton order is used only at the
snapshot boundary. Every gather clamps its indices explicitly (an
out-of-range index is an error in PyTorch, where jnp.take clips).

Reference semantics:
  bitfield_max_pool                        testbed.cu:119-166, 1120-1135
  mip_from_pos / mip_from_dt               testbed.cu:188-202
  cascaded_grid_idx_at / occupied_at       testbed.cu:234-264
  distance/advance_to_next_voxel           testbed.cu:293-315
  calc_dt                                  testbed.cu:230-232

The Chebyshev clearance grids (build_dist_grid, build_dist_grid_cascades,
dist_at) have no counterpart in the reference: they let the march hop
the whole empty ball around a voxel per lookup (march_cuda._dist_probe,
_dist_probe_mips).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.ops.morton import morton_order_lut

GRID = C.NERF_GRIDSIZE
N_MIPS = C.NERF_CASCADES


def build_occupancy(density_grid: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """density_grid (n_cascades, 128, 128, 128) float optical thickness ->
    occupancy (8, 128, 128, 128) uint8 in {0, 1}: threshold
    min(NERF_MIN_OPTICAL_THICKNESS, mean of mip 0), then each level
    max-pooled into the inner half of the next."""
    n_cascades = density_grid.shape[0]
    mean0 = torch.mean(torch.clamp(density_grid[0], min=0.0))
    thresh = torch.clamp(mean0, max=C.NERF_MIN_OPTICAL_THICKNESS)
    occ = density_grid > thresh
    occ[max_cascade + 1:] = False
    levels = [occ[0]]
    for lvl in range(1, N_MIPS):
        own = (occ[lvl].clone() if lvl < n_cascades
               else torch.zeros((GRID,) * 3, dtype=torch.bool,
                                device=density_grid.device))
        pooled = levels[-1].view(64, 2, 64, 2, 64, 2).amax(dim=(1, 3, 5))
        own[32:96, 32:96, 32:96] |= pooled
        levels.append(own)
    return torch.stack(levels).to(torch.uint8)


def _cell(q: torch.Tensor) -> torch.Tensor:
    """C-style truncation of q * GRID to a clamped int64 cell index; NaN
    maps to 0 like the reference's saturating float-to-int cast."""
    return torch.nan_to_num(q * GRID, nan=0.0).trunc().clamp(0, GRID - 1).long()


def mip_from_pos(pos: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """pos (..., 3) -> smallest mip whose cube contains pos."""
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    _, exponent = torch.frexp(maxval)
    return torch.clamp(exponent + 1, 0, max_cascade).to(torch.int32)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor, max_cascade: int):
    mip = mip_from_pos(pos, max_cascade)
    dt = dt * (2 * GRID)
    _, exponent = torch.frexp(dt)
    mip_dt = torch.where(dt < 1.0, mip,
                         torch.clamp(torch.maximum(exponent, mip),
                                     max=max_cascade))
    return mip_dt.to(torch.int32)


def occupied_at(occ: torch.Tensor, pos: torch.Tensor, mip: torch.Tensor):
    """occ (8, G, G, G) uint8; pos (..., 3); mip (...,) int -> bool."""
    mip = mip.long()
    scale = torch.exp2(-mip.float())[..., None]
    c = _cell((pos - 0.5) * scale + 0.5)
    flat = ((mip * GRID + c[..., 2]) * GRID + c[..., 1]) * GRID + c[..., 0]
    return occ.reshape(-1)[flat.clamp(0, occ.numel() - 1)].bool()


def calc_dt(t: torch.Tensor, cone_angle: float) -> torch.Tensor:
    if cone_angle == 0.0:
        return torch.full_like(t, C.MIN_CONE_STEPSIZE)
    return torch.clamp(t * cone_angle, C.MIN_CONE_STEPSIZE, C.MAX_CONE_STEPSIZE)


def distance_to_next_voxel(pos, dir, idir, res):
    """DDA distance to the next voxel boundary; res (...,) float."""
    p = res[..., None] * pos
    sign = torch.sign(dir) + (dir == 0.0).float()  # copysign(1, 0) == 1
    tt = (torch.floor(p + 0.5 + 0.5 * sign) - p) * idir
    t = torch.amin(tt, dim=-1)
    return torch.clamp(t / res, min=0.0)


def advance_to_next_voxel(t, cone_angle: float, pos, dir, idir, res):
    """Step t past the current (empty) voxel by multiples of dt: closed
    form for constant dt, a bounded do-while for cone stepping."""
    t_target = t + distance_to_next_voxel(pos, dir, idir, res)
    if cone_angle == 0.0:
        dt = C.MIN_CONE_STEPSIZE
        n = torch.clamp(torch.ceil((t_target - t) / dt), min=1.0)
        return t + n * dt
    t1 = t
    for _ in range(8):
        t1 = torch.where(t1 < t_target, t1 + calc_dt(t1, cone_angle), t1)
    return torch.maximum(t1, t + calc_dt(t, cone_angle))


def morton_cascades_to_linear(values_morton: np.ndarray) -> np.ndarray:
    """(n_cascades, 128^3) Morton-ordered -> (n_cascades, 128, 128, 128)
    in [z, y, x] layout (host numpy, snapshot interop)."""
    lut = morton_order_lut(GRID)
    n = values_morton.shape[0]
    return values_morton[:, lut].reshape(n, GRID, GRID, GRID)


def linear_cascades_to_morton(values_linear: np.ndarray) -> np.ndarray:
    """(n_cascades, 128, 128, 128) [z, y, x] -> (n_cascades, 128^3)
    Morton-ordered: the inverse of morton_cascades_to_linear."""
    lut = morton_order_lut(GRID)
    n = values_linear.shape[0]
    out = np.empty((n, GRID ** 3), values_linear.dtype)
    out[:, lut] = values_linear.reshape(n, -1)
    return out


def build_skip_grid(occ: torch.Tensor, max_level: int = 4) -> torch.Tensor:
    """Cascade-0 empty-space jump levels -> (G, G, G) uint8: 255 where
    occupied, else the coarsest level k <= max_level whose aligned 2^k
    block around the voxel is entirely empty."""
    g = occ[0] > 0
    skip = torch.zeros((GRID,) * 3, dtype=torch.uint8, device=occ.device)
    level = g
    for k in range(1, max_level + 1):
        n = GRID >> k
        level = level.view(n, 2, n, 2, n, 2).amax(dim=(1, 3, 5))
        s = 1 << k
        up = (level.repeat_interleave(s, 0).repeat_interleave(s, 1)
              .repeat_interleave(s, 2))
        skip = torch.where(up, skip, k)
    return torch.where(g, 255, skip).to(torch.uint8)


def skip_level_at(skip: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Jump levels at cascade-0 positions (..., 3) -> (...,) uint8."""
    c = _cell(pos)
    return skip.reshape(-1)[(c[..., 2] * GRID + c[..., 1]) * GRID + c[..., 0]]


def _dilate_chebyshev(g: torch.Tensor) -> torch.Tensor:
    """One 3x3x3 Chebyshev dilation of a bool grid (..., G, G, G), zero
    beyond the edges: nothing is occupied outside a cascade's cube.
    Separable: each axis ORs in its two shifted neighbours."""
    for axis in (-3, -2, -1):
        n = g.shape[axis]
        out = g.clone()
        out.narrow(axis, 0, n - 1).logical_or_(g.narrow(axis, 1, n - 1))
        out.narrow(axis, 1, n - 1).logical_or_(g.narrow(axis, 0, n - 1))
        g = out
    return g


def build_dist_grid(occ: torch.Tensor, max_dist: int = 31,
                    level: int = 0) -> torch.Tensor:
    """Chebyshev distance in voxels to the nearest occupied `level` voxel
    -> (G, G, G) uint8 on the occupancy's device; 0 = occupied, capped at
    max_dist. After k dilations a voxel is marked iff its distance is
    <= k, so the unmarked indicator summed over the rounds is the capped
    distance."""
    return build_dist_grid_cascades(occ[level:level + 1], 0, max_dist)[0]


def build_dist_grid_cascades(occ: torch.Tensor, max_cascade: int,
                             max_dist: int = 31) -> torch.Tensor:
    """Per-cascade clearance pyramid -> (max_cascade + 1, G, G, G) uint8,
    each level in its own cascade-local voxels; the levels dilate
    together.

    build_occupancy pools each finer level into the inner half of the
    next, so an empty cascade-c ball holds no finer-cascade content;
    coarser cascades may still be occupied there, which is why the probe
    clamps its hop (march_cuda._dist_probe_mips)."""
    cur = occ[:max_cascade + 1] > 0
    dist = (~cur).to(torch.uint8)
    for _ in range(max_dist - 1):
        cur = _dilate_chebyshev(cur)
        dist += ~cur
    return dist


def dist_at(dist: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Clearance at cascade-0 positions (..., 3) -> (...,) uint8, indexed
    like skip_level_at."""
    return skip_level_at(dist, pos)

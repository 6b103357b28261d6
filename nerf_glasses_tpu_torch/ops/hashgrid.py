"""Multiresolution hash-grid encoding (Instant-NGP).

Port of nerf_glasses_tpu/ops/hashgrid.py: tiny-cuda-nn's GridEncoding
with otype=HashGrid, hash=CoherentPrime, interpolation=Linear
(encodings/grid.h:112-198, 260-395). The table is a uniform
(n_levels, S, F) tensor, every level padded to the largest level's rows.

Index arithmetic is uint32 in the reference. PyTorch's uint32 support
for `*`, `^` and `>>` is incomplete, so it runs in int64 and is masked
with 0xFFFFFFFF after every multiply: the same bits, wraparound included.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig, grid_scale

U32 = 0xFFFFFFFF


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c,
    in two 16-bit halves of c so that no int64 product overflows."""
    lo = (x * (c & 0xFFFF)) & U32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


# The 8 corner offsets of a cell; bit i of the corner index selects dim i.
_CORNERS = np.array([[(i >> d) & 1 for d in range(3)] for i in range(8)],
                    dtype=np.int64)
_corners_on = {}


def _corner_offsets(device) -> torch.Tensor:
    """_CORNERS as an (8, 3) int64 tensor on `device`, copied there once
    per device: a copy from pageable host memory on every level of every
    call would wait for the stream each time."""
    dev = torch.device(device)
    t = _corners_on.get(dev)
    if t is None:
        t = _corners_on[dev] = torch.as_tensor(_CORNERS, device=dev)
    return t


def level_constants(config: NGPConfig):
    """Per-level (scale, resolution, hashmap_size, is_dense) numpy arrays."""
    lp = config.level_params()
    scales = np.array(
        [grid_scale(lvl, config.log2_per_level_scale, config.base_resolution)
         for lvl in range(config.n_levels)], np.float32)
    res = np.array([p[2] for p in lp], np.uint32)
    sizes = np.array([p[1] for p in lp], np.uint32)
    dense = np.array([(not config.all_hash) and int(p[2]) ** 3 <= int(p[1])
                      for p in lp], bool)
    return scales, res, sizes, dense


def padded_table_rows(config: NGPConfig) -> int:
    return max(p[1] for p in config.level_params())


def corner_indices_and_weights(pos: torch.Tensor, scale: float,
                               resolution: int, hashmap_size: int,
                               dense: bool):
    """pos (N, 3) in [0, 1] -> (idx (N, 8) int64 table rows, weights
    (N, 8) f32 trilinear)."""
    p = pos * float(np.float32(scale)) + 0.5
    grid_f = torch.floor(p)
    frac = p - grid_f
    corners_off = _corner_offsets(pos.device)
    corners = grid_f.to(torch.int64)[:, None, :] + corners_off[None]
    w = torch.where(corners_off[None].bool(), frac[:, None, :],
                    1.0 - frac[:, None, :])
    weights = w[..., 0] * w[..., 1] * w[..., 2]

    cu = corners & U32            # int32 -> uint32 reinterpretation
    if dense:
        idx = (cu[..., 0] + mul_u32(cu[..., 1], resolution)
               + mul_u32(cu[..., 2], (resolution * resolution) & U32)) & U32
    else:
        idx = (mul_u32(cu[..., 0], C.HASH_PRIMES[0])
               ^ mul_u32(cu[..., 1], C.HASH_PRIMES[1])
               ^ mul_u32(cu[..., 2], C.HASH_PRIMES[2]))
    if hashmap_size & (hashmap_size - 1) == 0:
        idx = idx & (hashmap_size - 1)
    else:
        idx = idx % hashmap_size
    return idx, weights


def level_corner_indices(pos: torch.Tensor, resolution: int, scale: float,
                         hashmap_size: int):
    """One level's corner rows and trilinear weights, dense indexing when
    the level's grid fits its table."""
    dense = resolution ** 3 <= hashmap_size
    return corner_indices_and_weights(pos, float(scale), int(resolution),
                                      int(hashmap_size), dense)


def take_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (S, F), idx (N, 8) -> (N, 8, F) row gather. index_select's
    gradient is an index_add_ into the table (atomic adds on CUDA)."""
    return tab.index_select(0, idx.reshape(-1)).view(*idx.shape, tab.shape[-1])


def hash_encode(table: torch.Tensor, pos: torch.Tensor, config: NGPConfig,
                compute_dtype=torch.float32) -> torch.Tensor:
    """table (L, S, F); pos (N, 3) in [0, 1] -> (N, L*F) features,
    level-major: one batched (N*8)-row gather per level."""
    scales, res, sizes, dense = level_constants(config)
    feats = []
    for lvl in range(config.n_levels):
        idx, w = corner_indices_and_weights(
            pos, float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
            bool(dense[lvl]))
        vals = take_rows(table[lvl], idx)                  # (N, 8, F)
        feats.append(torch.sum(vals.to(compute_dtype)
                               * w[..., None].to(compute_dtype), dim=1))
    return torch.cat(feats, dim=-1)


def hash_table_init(generator: torch.Generator, config: NGPConfig,
                    device="cpu") -> torch.Tensor:
    """U(-1e-4, 1e-4) table (L, S, F), tcnn grid.h initialize_params.
    Rows past a level's hashmap size are drawn too; no lookup reads them
    and table_to_tcnn drops them."""
    shape = (config.n_levels, padded_table_rows(config),
             config.n_features_per_level)
    u = torch.rand(shape, generator=generator, device=device)
    return u * 2e-4 - 1e-4


def table_to_tcnn(table: np.ndarray, config: NGPConfig) -> np.ndarray:
    """(L, S, F) padded -> flat tcnn param vector (offset-table layout)."""
    F = config.n_features_per_level
    return np.concatenate([np.asarray(table[lvl][:size, :F]).reshape(-1)
                           for lvl, (_off, size, _res)
                           in enumerate(config.level_params())])


def table_from_tcnn(flat: np.ndarray, config: NGPConfig) -> np.ndarray:
    """Flat tcnn param vector (offset-table layout) -> (L, S, F) padded."""
    F = config.n_features_per_level
    out = np.zeros((config.n_levels, padded_table_rows(config), F), np.float32)
    for lvl, (offset, size, _res) in enumerate(config.level_params()):
        out[lvl, :size] = flat[offset * F:(offset + size) * F].reshape(size, F)
    return out

"""Composite NeRF network: hash grid -> density MLP, SH -> rgb MLP.

Port of nerf_glasses_tpu/ops/network.py (NerfNetwork<T>,
src/ngp/nerf_network.cuh:75-135):

    density path: pos(3) --HashGrid--> density MLP -> 16
    color path:   [density_out(16), SH(dir)(16), pad] -> rgb MLP -> 16
    outputs:      rgb = rgb_out[:, :3], sigma = density_out[:, 0]
                  (both pre-activation)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops.hashgrid import hash_encode, table_from_tcnn
from nerf_glasses_tpu_torch.ops.mlp import mlp_apply
from nerf_glasses_tpu_torch.ops.sh import sh_encode


class NerfNetwork(nn.Module):
    """The hash table (L, S, F) and both MLPs' weights, as buffers (the
    port does not train yet)."""

    def __init__(self, config: NGPConfig, grid: torch.Tensor,
                 density_mlp, rgb_mlp):
        super().__init__()
        self.config = config
        self.register_buffer("grid", grid)
        self.n_density = len(density_mlp)
        for i, w in enumerate(density_mlp):
            self.register_buffer(f"density_{i}", w)
        self.n_rgb = len(rgb_mlp)
        for i, w in enumerate(rgb_mlp):
            self.register_buffer(f"rgb_{i}", w)

    @property
    def density_mlp(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"density_{i}")
                     for i in range(self.n_density))

    @property
    def rgb_mlp(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"rgb_{i}") for i in range(self.n_rgb))

    def density_raw(self, pos01: torch.Tensor, compute_dtype=torch.bfloat16,
                    encode_dtype=torch.float32) -> torch.Tensor:
        """pos01 (N, 3) in [0, 1] -> density MLP output (N, 16); sigma is
        channel 0 (NerfNetwork::density, nerf_network.cuh:266-282)."""
        enc = hash_encode(self.grid, pos01, self.config,
                          compute_dtype=encode_dtype)
        return mlp_apply(enc, self.density_mlp, compute_dtype=compute_dtype)

    def rgb_from_features(self, feat: torch.Tensor, dir01: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
        """[density-MLP output (N, 16), SH(dir), pad] -> rgb_raw (N, 3):
        the colour half of NerfNetwork::inference (nerf_network.cuh:75-135),
        also called on features read from a baked grid (ops/bake.py)."""
        cfg = self.config
        sh = sh_encode(dir01, cfg.sh_degree, cfg.sh_out_padded)
        parts = [feat.float(), sh]
        width = feat.shape[-1] + sh.shape[-1]
        if width < cfg.rgb_in_width:
            parts.append(torch.zeros((feat.shape[0], cfg.rgb_in_width - width),
                                     device=feat.device))
        rgb_out = mlp_apply(torch.cat(parts, dim=-1), self.rgb_mlp,
                            compute_dtype=compute_dtype)
        return rgb_out[..., :3]

    def forward(self, pos01: torch.Tensor, dir01: torch.Tensor,
                compute_dtype=torch.bfloat16):
        """-> (rgb_raw (N, 3), sigma_raw (N,)), pre-activation f32.
        Extra learnable dims, where the config has them, are zeros."""
        d_out = self.density_raw(pos01, compute_dtype)
        return self.rgb_from_features(d_out, dir01, compute_dtype), d_out[..., 0]

    apply_network = forward


def _network(config, grid, density, rgb, device) -> NerfNetwork:
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return NerfNetwork(config, t(grid), [t(w) for w in density],
                       [t(w) for w in rgb])


def unpack_params(blob: np.ndarray, config: NGPConfig,
                  device="cpu") -> NerfNetwork:
    """The snapshot's fp16 (or fp32) params blob, tcnn order density MLP,
    rgb MLP, hash grid (nerf_network.cuh:359-392) -> NerfNetwork."""
    flat = np.asarray(blob, dtype=np.float32)
    if flat.size != config.n_params:
        raise ValueError(f"params_binary has {flat.size} params, "
                         f"expected {config.n_params}")
    d_shapes, r_shapes = config.mlp_shapes()
    off = 0
    mats = []
    for shape in d_shapes + r_shapes:
        n = shape[0] * shape[1]
        mats.append(flat[off:off + n].reshape(shape))
        off += n
    grid = table_from_tcnn(flat[off:off + config.n_grid_params], config)
    return _network(config, grid, mats[:len(d_shapes)],
                    mats[len(d_shapes):], device)


def params_from_jax(params_np: Dict[str, object], config: NGPConfig,
                    device="cpu") -> NerfNetwork:
    """The JAX package's params dict as numpy arrays ({"density_mlp":
    (...), "rgb_mlp": (...), "grid": (L, S, F)}) -> NerfNetwork."""
    d_shapes, r_shapes = config.mlp_shapes()
    density, rgb = params_np["density_mlp"], params_np["rgb_mlp"]
    grid = np.asarray(params_np["grid"], np.float32)
    F = config.n_features_per_level
    if ([tuple(np.shape(w)) for w in density] != list(d_shapes)
            or [tuple(np.shape(w)) for w in rgb] != list(r_shapes)
            or grid.shape[:2] != (config.n_levels,
                                  max(p[1] for p in config.level_params()))
            or grid.shape[2] < F):
        raise ValueError("params do not match the config's shapes")
    return _network(config, grid[..., :F], density, rgb, device)


def apply_density_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "none":
        return x
    if kind == "relu":
        return torch.relu(x)
    if kind == "logistic":
        return torch.sigmoid(x)
    if kind == "exponential":
        return torch.exp(x)
    raise ValueError(kind)


def apply_rgb_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "exponential":
        return torch.exp(torch.clamp(x, -10.0, 10.0))
    return apply_density_activation(x, kind)

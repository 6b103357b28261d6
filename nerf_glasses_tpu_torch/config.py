"""Model configuration for the Instant-NGP NeRF network.

Port of nerf_glasses_tpu/config.py. The configuration mirrors the
snapshot's embedded network config sections (`encoding` /
`dir_encoding` / `network` / `rgb_network`). Unlike the reference, the
snapshot parse rejects component types it does not implement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


def per_level_scale_for(aabb_scale: int, n_levels: int = 16,
                        base_resolution: int = 16,
                        desired_resolution: float = 2048.0) -> float:
    """Automatic per-level scale (testbed.cu:1197-1204)."""
    return math.exp(
        math.log(desired_resolution * float(aabb_scale) / float(base_resolution))
        / (n_levels - 1))


def grid_scale(level: int, log2_per_level_scale: float,
               base_resolution: int) -> float:
    """Grid vertex scale of a level (tiny-cuda-nn grid.h:194-198)."""
    return float(np.exp2(level * log2_per_level_scale) * base_resolution - 1.0)


def grid_resolution(scale: float) -> int:
    """(tiny-cuda-nn grid.h:201-203)"""
    return int(np.ceil(scale)) + 1


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """NeRF model configuration (iNGP defaults); fields as in the JAX
    package's NGPConfig, without its TPU-only table row padding."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = per_level_scale_for(1)
    sh_degree: int = 4
    density_neurons: int = 64
    density_hidden_layers: int = 1
    density_out: int = 16
    rgb_neurons: int = 64
    rgb_hidden_layers: int = 2
    rgb_out_padded: int = 16
    aabb_scale: int = 1
    n_extra_learnable_dims: int = 0
    # every level a 2^log2_hashmap_size hash table ({"hash": "UniformPow2"})
    all_hash: bool = False
    density_activation: str = "exponential"
    rgb_activation: str = "logistic"

    @property
    def log2_per_level_scale(self) -> float:
        return math.log2(self.per_level_scale)

    @property
    def n_pos_features(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def sh_out_padded(self) -> int:
        return _next_multiple(self.sh_degree * self.sh_degree, 16)

    @property
    def rgb_in_width(self) -> int:
        return _next_multiple(self.sh_out_padded + self.density_out
                              + self.n_extra_learnable_dims, 16)

    @property
    def max_cascade(self) -> int:
        c = 0
        while (1 << c) < self.aabb_scale:
            c += 1
        return c

    @property
    def cone_angle_constant(self) -> float:
        return 0.0 if self.aabb_scale <= 1 else 1.0 / 256.0

    def level_params(self) -> Tuple[Tuple[int, int, int], ...]:
        """Per level: (offset, hashmap_size, resolution) in feature rows
        (tiny-cuda-nn grid.h:985-1018)."""
        out = []
        offset = 0
        for lvl in range(self.n_levels):
            res = grid_resolution(grid_scale(lvl, self.log2_per_level_scale,
                                             self.base_resolution))
            if self.all_hash:
                params_in_level = 1 << self.log2_hashmap_size
            else:
                params_in_level = min(res ** 3, 2 ** 31)
                params_in_level = _next_multiple(params_in_level, 8)
                params_in_level = min(params_in_level,
                                      1 << self.log2_hashmap_size)
            out.append((offset, params_in_level, res))
            offset += params_in_level
        return tuple(out)

    @property
    def n_grid_rows(self) -> int:
        lp = self.level_params()
        return lp[-1][0] + lp[-1][1]

    @property
    def n_grid_params(self) -> int:
        return self.n_grid_rows * self.n_features_per_level

    def mlp_shapes(self):
        """Weight shapes ([n_out, n_in]) of the density and rgb MLPs, in
        serialization order (fully_fused_mlp.cu:636-687)."""
        d = [(self.density_neurons, self.n_pos_features)]
        for _ in range(self.density_hidden_layers - 1):
            d.append((self.density_neurons, self.density_neurons))
        d.append((self.density_out, self.density_neurons))
        r = [(self.rgb_neurons, self.rgb_in_width)]
        for _ in range(self.rgb_hidden_layers - 1):
            r.append((self.rgb_neurons, self.rgb_neurons))
        r.append((self.rgb_out_padded, self.rgb_neurons))
        return tuple(d), tuple(r)

    @property
    def n_params(self) -> int:
        d, r = self.mlp_shapes()
        n = sum(a * b for a, b in d) + sum(a * b for a, b in r)
        return n + self.n_grid_params

    def to_snapshot_config(self) -> dict:
        """The snapshot's network config sections (the JAX package's
        NGPConfig.to_snapshot_config, without its wide-row flag)."""
        mlp = {"otype": "FullyFusedMLP", "activation": "ReLU",
               "output_activation": "None"}
        return {
            "encoding": {
                "otype": "HashGrid",
                "n_levels": self.n_levels,
                "n_features_per_level": self.n_features_per_level,
                "log2_hashmap_size": self.log2_hashmap_size,
                "base_resolution": self.base_resolution,
                "per_level_scale": self.per_level_scale,
                "n_pos_dims": 3,
                "interpolation": "Linear",
                **({"hash": "UniformPow2"} if self.all_hash else {}),
            },
            "dir_encoding": {"otype": "SphericalHarmonics",
                             "degree": self.sh_degree},
            "network": {**mlp, "n_neurons": self.density_neurons,
                        "n_hidden_layers": self.density_hidden_layers},
            "rgb_network": {**mlp, "n_neurons": self.rgb_neurons,
                            "n_hidden_layers": self.rgb_hidden_layers},
            "loss": {"otype": "L2"},
            **({"n_extra_learnable_dims": self.n_extra_learnable_dims}
               if self.n_extra_learnable_dims else {}),
            "optimizer": {"otype": "Adam", "learning_rate": 1e-3,
                          "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
                          "l2_reg": 1e-6},
        }

    @staticmethod
    def native_fast(aabb_scale: int = 1) -> "NGPConfig":
        """8 levels x 4 features, uniform 2^15-row hash tables."""
        return NGPConfig(
            n_levels=8, n_features_per_level=4, log2_hashmap_size=15,
            base_resolution=16,
            per_level_scale=math.exp(math.log(2048.0 * aabb_scale / 16.0) / 7.0),
            aabb_scale=aabb_scale, all_hash=True)

    @staticmethod
    def from_snapshot_config(cfg: dict, aabb_scale: int,
                             is_hdr: bool = False) -> "NGPConfig":
        enc = cfg.get("encoding", {})
        net = cfg.get("network", {})
        rgb = cfg.get("rgb_network", {})
        dir_enc = cfg.get("dir_encoding", {})
        for name, sec, want in (
                ("encoding", enc, ("HashGrid",)),
                ("dir_encoding", dir_enc, ("SphericalHarmonics",)),
                ("network", net, ("FullyFusedMLP", "CutlassMLP")),
                ("rgb_network", rgb, ("FullyFusedMLP", "CutlassMLP"))):
            otype = sec.get("otype", want[0])
            if otype not in want:
                raise ValueError(f"snapshot {name}.otype {otype!r} is not "
                                 f"supported (expected one of {want})")
        for sec in (net, rgb):
            if sec.get("activation", "ReLU") != "ReLU" or \
                    sec.get("output_activation", "None") != "None":
                raise ValueError(f"unsupported MLP activations in {sec}")
        if enc.get("interpolation", "Linear") != "Linear":
            raise ValueError("only Linear hash-grid interpolation is supported")
        n_levels = int(enc.get("n_levels", 16))
        base_res = int(enc.get("base_resolution", 16))
        pls = float(enc.get("per_level_scale", 0.0))
        if pls <= 0.0:
            pls = per_level_scale_for(aabb_scale, n_levels, base_res)
        return NGPConfig(
            n_levels=n_levels,
            n_features_per_level=int(enc.get("n_features_per_level", 2)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=base_res,
            per_level_scale=pls,
            all_hash=enc.get("hash", "CoherentPrime") == "UniformPow2",
            sh_degree=int(dir_enc.get("degree", 4)),
            density_neurons=int(net.get("n_neurons", 64)),
            density_hidden_layers=int(net.get("n_hidden_layers", 1)),
            rgb_neurons=int(rgb.get("n_neurons", 64)),
            rgb_hidden_layers=int(rgb.get("n_hidden_layers", 2)),
            aabb_scale=int(aabb_scale),
            n_extra_learnable_dims=int(cfg.get("n_extra_learnable_dims", 0)),
            density_activation="exponential",
            rgb_activation="exponential" if is_hdr else "logistic")

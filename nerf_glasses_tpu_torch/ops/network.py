"""Composite NeRF network: hash grid -> density MLP, SH -> rgb MLP.

Port of nerf_glasses_tpu/ops/network.py (NerfNetwork<T>,
src/ngp/nerf_network.cuh:75-135):

    density path: pos(3) --HashGrid--> density MLP -> 16
    color path:   [density_out(16), SH(dir)(16), latent codes(E), pad]
                  -> rgb MLP -> 16
    outputs:      rgb = rgb_out[:, :3], sigma = density_out[:, 0]
                  (both pre-activation)

Where the network runs (network_cuda.takes_kernel): a CPU tensor takes
the plain versions (hashgrid.hash_encode, mlp.mlp_apply,
network_cuda.rgb_head_reference), which autograd differentiates; a CUDA
tensor that needs no gradient (`not torch.is_grad_enabled()`, or no
input and no parameter requires grad: every render, sweep, collide, bake
and density query, and the trainer's no-grad queries) takes the CUDA
kernels of csrc/network.cu: at the bf16 compute dtype the density half
is one launch of the fused encode + MLP kernel (nmr_encode_mlp), at f32
the encode and the MLP kernels, one launch each; the rgb head is one
launch. A CUDA call that needs gradients (the trainer's forward,
network_cuda.trains_on_card) takes the autograd Functions
network_cuda.HashEncode -> Mlp -> RgbHead: their forwards are the
kernels nmr_hash_encode, nmr_mlp and nmr_rgb_head, their backwards
nmr_hash_encode_backward, nmr_mlp_backward and nmr_rgb_head_backward,
so no plain version runs on the card (network_cuda.plain_on_card stays
0). There is no fallback: a build or launch failure raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops import network_cuda
from nerf_glasses_tpu_torch.ops.hashgrid import (hash_encode, hash_table_init,
                                                 table_from_tcnn, table_to_tcnn)
from nerf_glasses_tpu_torch.ops.mlp import mlp_apply, mlp_init


class NerfNetwork(nn.Module):
    """The hash table (L, S, F) and both MLPs' weights as parameters.

    They are created with requires_grad off: a loaded snapshot only
    renders. The trainer turns gradients on for its own network
    (`requires_grad_(True)`); the render entry points run under
    torch.no_grad(), so rendering a network that trains builds no
    graph."""

    def __init__(self, config: NGPConfig, grid: torch.Tensor,
                 density_mlp, rgb_mlp):
        super().__init__()
        self.config = config
        self.grid = nn.Parameter(grid, requires_grad=False)
        self.n_density = len(density_mlp)
        for i, w in enumerate(density_mlp):
            setattr(self, f"density_{i}", nn.Parameter(w, requires_grad=False))
        self.n_rgb = len(rgb_mlp)
        for i, w in enumerate(rgb_mlp):
            setattr(self, f"rgb_{i}", nn.Parameter(w, requires_grad=False))

    @property
    def density_mlp(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"density_{i}")
                     for i in range(self.n_density))

    @property
    def rgb_mlp(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"rgb_{i}") for i in range(self.n_rgb))

    def row_buffers(self, n: int, compute_dtype=torch.bfloat16,
                    encode_dtype=torch.float32, device=None) -> dict:
        """Outputs for a forward on n rows (forward's `out`): "density"
        (n, density_out) f32 and "rgb" (n, 3) f32; at the f32 compute
        dtype also the encode's "encode" (n, L*F) in encode_dtype. On the
        CPU "rgb" is the first 3 columns of the rgb MLP's whole output
        width, the layout its plain version returns: aten's CPU
        activations round strided and contiguous inputs apart, and the
        composite applies them to these rows."""
        device = torch.device(self.grid.device if device is None else device)
        f32 = dict(dtype=torch.float32, device=device)
        width = 3 if device.type == "cuda" else self.rgb_mlp[-1].shape[0]
        out = {"density": torch.empty((n, self.density_mlp[-1].shape[0]),
                                      **f32),
               "rgb": torch.empty((n, width), **f32)[:, :3]}
        if compute_dtype != torch.bfloat16:
            out["encode"] = torch.empty((n, self.config.n_pos_features),
                                        dtype=encode_dtype, device=device)
        return out

    def density_raw(self, pos01: torch.Tensor, compute_dtype=torch.bfloat16,
                    encode_dtype=torch.float32, count=None,
                    out=None) -> torch.Tensor:
        """pos01 (N, 3) in [0, 1] -> density MLP output (N, 16); sigma is
        channel 0 (NerfNetwork::density, nerf_network.cuh:266-282).
        count: None, or one int32 on pos01's device: the rows below it
        alone are computed, into out["density"] (and out["encode"] at the
        f32 compute dtype; row_buffers), N bounding the count; the rows
        above it keep what they held. A count takes the wrappers of
        network_cuda (the kernels on a CUDA tensor, their plain versions
        on a CPU one) and a call that needs no gradient."""
        if count is not None:
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (self.grid, pos01,
                                              *self.density_mlp)):
                raise ValueError("density_raw: a row count takes a call "
                                 "that needs no gradient")
            pos01, out = pos01.contiguous(), out or {}
            if compute_dtype == torch.bfloat16:
                return network_cuda.encode_mlp(
                    self.grid, pos01, self.density_mlp, self.config,
                    compute_dtype, encode_dtype, count, out.get("density"))
            enc = network_cuda.hash_encode(self.grid, pos01, self.config,
                                           encode_dtype, count,
                                           out.get("encode"))
            return network_cuda.mlp(enc, self.density_mlp, compute_dtype,
                                    count, out.get("density"))
        if network_cuda.trains_on_card(self.grid, pos01, *self.density_mlp):
            enc = network_cuda.HashEncode.apply(self.grid, pos01.contiguous(),
                                                self.config, encode_dtype)
            return network_cuda.Mlp.apply(enc, compute_dtype,
                                          *self.density_mlp)
        if compute_dtype == torch.bfloat16:
            if network_cuda.takes_kernel("encode_mlp", self.grid, pos01,
                                         *self.density_mlp):
                return network_cuda.encode_mlp(
                    self.grid, pos01.contiguous(), self.density_mlp,
                    self.config, compute_dtype, encode_dtype)
            return mlp_apply(hash_encode(self.grid, pos01, self.config,
                                         compute_dtype=encode_dtype),
                             self.density_mlp, compute_dtype=compute_dtype)
        elif network_cuda.takes_kernel("hash_encode", self.grid, pos01):
            enc = network_cuda.hash_encode(self.grid, pos01.contiguous(),
                                           self.config, encode_dtype)
        else:
            enc = hash_encode(self.grid, pos01, self.config,
                              compute_dtype=encode_dtype)
        if network_cuda.takes_kernel("mlp", enc, *self.density_mlp):
            return network_cuda.mlp(enc, self.density_mlp, compute_dtype)
        return mlp_apply(enc, self.density_mlp, compute_dtype=compute_dtype)

    def rgb_from_features(self, feat: torch.Tensor, dir01: torch.Tensor,
                          compute_dtype=torch.bfloat16,
                          extra: torch.Tensor = None, count=None,
                          out=None) -> torch.Tensor:
        """[density-MLP output (N, 16), SH(dir), extra dims, pad] ->
        rgb_raw (N, 3): the colour half of NerfNetwork::inference
        (nerf_network.cuh:75-135), also called on features read from a
        baked grid (ops/bake.py). `extra` ((N, E) or (E,)) are the latent
        codes of a config with n_extra_learnable_dims = E (upstream's
        extra-dims path, testbed.cu:1614-1631); zeros when omitted. count
        and out ((N, 3) f32) as in density_raw."""
        if count is not None:
            return network_cuda.rgb_head(
                feat.float().contiguous(), dir01.float().contiguous(),
                self.rgb_mlp, self.config, compute_dtype,
                None if extra is None else extra.float().contiguous(), count,
                out)
        if network_cuda.trains_on_card(feat, dir01, extra, *self.rgb_mlp):
            return network_cuda.RgbHead.apply(
                feat.float().contiguous(), dir01.float().contiguous(),
                None if extra is None else extra.float().contiguous(),
                self.config, compute_dtype, *self.rgb_mlp)
        if network_cuda.takes_kernel("rgb_head", feat, dir01, extra,
                                     *self.rgb_mlp):
            return network_cuda.rgb_head(
                feat.float().contiguous(), dir01.float().contiguous(),
                self.rgb_mlp, self.config, compute_dtype,
                None if extra is None else extra.float().contiguous())
        return network_cuda.rgb_head_reference(feat, dir01, self.rgb_mlp,
                                               self.config, compute_dtype,
                                               extra)

    def forward(self, pos01: torch.Tensor, dir01: torch.Tensor,
                compute_dtype=torch.bfloat16, encode_dtype=torch.float32,
                extra: torch.Tensor = None, count=None, out=None):
        """-> (rgb_raw (N, 3), sigma_raw (N,)), pre-activation f32; `extra`
        as in rgb_from_features. count (one int32 on the device) and out
        (row_buffers' dict) as in density_raw: the rows below the count
        are computed into out's buffers, which the result views."""
        d_out = self.density_raw(pos01, compute_dtype, encode_dtype, count,
                                 out)
        return (self.rgb_from_features(
            d_out, dir01, compute_dtype, extra, count,
            None if out is None else out["rgb"]), d_out[..., 0])

    apply_network = forward

    def detached_copy(self) -> "NerfNetwork":
        """A copy with its own storage and gradients off (a trainer's
        network handed to a renderer that must not see later steps)."""
        return NerfNetwork(self.config, self.grid.detach().clone(),
                           [w.detach().clone() for w in self.density_mlp],
                           [w.detach().clone() for w in self.rgb_mlp])


def init_params(config: NGPConfig, generator: torch.Generator,
                device="cpu") -> NerfNetwork:
    """Fresh network (the JAX package's init_params): Xavier-uniform MLP
    weights, a U(-1e-4, 1e-4) hash table, drawn from `generator`."""
    d_shapes, r_shapes = config.mlp_shapes()
    density = mlp_init(generator, d_shapes, device)
    rgb = mlp_init(generator, r_shapes, device)
    return NerfNetwork(config, hash_table_init(generator, config, device),
                       density, rgb)


def pack_params(net: NerfNetwork) -> np.ndarray:
    """NerfNetwork -> the fp16 params blob in tcnn order: density MLP,
    rgb MLP, hash grid (NerfNetwork::set_params,
    nerf_network.cuh:359-392)."""
    config = net.config
    parts = [w.detach().cpu().float().numpy().reshape(-1)
             for w in net.density_mlp + net.rgb_mlp]
    parts.append(table_to_tcnn(net.grid.detach().cpu().float().numpy(),
                               config))
    flat = np.concatenate(parts)
    if flat.size != config.n_params:
        raise ValueError(f"packed {flat.size} params, the config has "
                         f"{config.n_params}")
    return flat.astype(np.float16)


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

"""Color-space conversion, tonemapping and progressive accumulation.

Port of nerf_glasses_tpu/ops/colors.py (reference ngp_common.cuh:125-147
for sRGB, render_buffer.cu:232-347 for accumulation and tonemap).
"""

from __future__ import annotations

import torch


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-12), 0.41666)
                       - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow(torch.clamp((x + 0.055) / 1.055, min=0.0), 2.4))


def tonemap_curve(x: torch.Tensor, curve: str = "identity") -> torch.Tensor:
    """Filmic tonemap curves (render_buffer.cu:270-327)."""
    if curve == "identity":
        return x
    x = torch.clamp(x, min=0.0)
    if curve == "aces":
        k0, k1, k2 = 0.6 * 0.6 * 2.51, 0.6 * 0.03, 0.0
        k3, k4, k5 = 0.6 * 0.6 * 2.43, 0.6 * 0.59, 0.14
    elif curve == "hable":
        A, B, Cc, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        k0, k1, k2 = A * F - A * E, Cc * B * F - B * E, 0.0
        k3, k4, k5 = A * F, B * F, D * F * F
        W = 11.2
        white_scale = (k3 * W * W + k4 * W + k5) / (k0 * W * W + k1 * W + k2)
        k0, k1, k2 = 4.0 * k0 * white_scale, 2.0 * k1 * white_scale, \
            k2 * white_scale
        k3, k4 = 4.0 * k3, 2.0 * k4
    elif curve == "reinhard":
        lum = x[..., 0] * 0.2126 + x[..., 1] * 0.7152 + x[..., 2] * 0.0722
        return x / (lum[..., None] + 1.0)
    else:
        raise ValueError(f"unknown tonemap curve {curve!r}")
    x2 = x * x
    return (x2 * k0 + k1 * x + k2) / (k3 * x2 + k4 * x + k5)


def tonemap(color3, exposure: float, curve: str, color_space: str,
            output_color_space: str):
    """Full tonemap chain (render_buffer.cu:329-347)."""
    if color_space == "srgb":
        color3 = srgb_to_linear(color3)
    color3 = color3 * float(2.0 ** float(exposure))
    color3 = tonemap_curve(color3, curve)
    if output_color_space == "srgb":
        color3 = linear_to_srgb(color3)
    return color3


def tonemap_frame(accum_rgba: torch.Tensor, exposure: float = 0.0,
                  background_rgba=(1.0, 1.0, 1.0, 1.0),
                  color_space: str = "linear",
                  output_color_space: str = "srgb",
                  curve: str = "identity",
                  clamp_output: bool = True) -> torch.Tensor:
    """Background compositing + tonemap (render_buffer.cu tonemap_kernel).
    accum_rgba (..., 4) premultiplied; the background is sRGB."""
    bg = torch.as_tensor(background_rgba, dtype=accum_rgba.dtype,
                         device=accum_rgba.device)
    bg_rgb = bg[..., :3]
    if color_space != "srgb":
        bg_rgb = srgb_to_linear(bg_rgb)
    rgb = accum_rgba[..., :3]
    a = accum_rgba[..., 3:4]
    weight = (1.0 - a) * bg[..., 3:4]
    rgb = rgb + bg_rgb * weight
    a = a + weight
    rgb = tonemap(rgb, exposure, curve, color_space, output_color_space)
    out = torch.cat([rgb, a], dim=-1)
    if clamp_output and output_color_space == "srgb":
        out = torch.clamp(out, 0.0, 1.0)
    return out


def accumulate(accum_rgba, frame_rgba, spp: int, color_space: str = "linear"):
    """Progressive supersampling average (render_buffer.cu:232-268)."""
    color = frame_rgba
    if color_space == "srgb":
        color = torch.cat([linear_to_srgb(color[..., :3]), color[..., 3:]],
                          dim=-1)
    if spp == 0:
        return color
    return (accum_rgba * float(spp) + color) / float(spp + 1)

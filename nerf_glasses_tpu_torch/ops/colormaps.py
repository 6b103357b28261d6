"""Turbo / viridis colormaps and the depth overlay, on tensors.

Port of nerf_glasses_tpu/ops/colormaps.py (colormap_turbo /
colormap_viridis + overlay_depth kernels, src/ngp/render_buffer.cu:
421-535).
"""

from __future__ import annotations

import torch

_TURBO_4 = ((0.13572138, 4.61539260, -42.66032258, 132.13108234),
            (0.09140261, 2.19418839, 4.84296658, -14.18503333),
            (0.10667330, 12.64194608, -60.58204836, 110.36276771))
_TURBO_2 = ((-152.94239396, 59.28637943),
            (4.27729857, 2.82956604),
            (-89.90310912, 27.34824973))

_VIRIDIS_ANCHORS = (
    (0.267004, 0.004874, 0.329415),
    (0.282623, 0.140926, 0.457517),
    (0.253935, 0.265254, 0.529983),
    (0.206756, 0.371758, 0.553117),
    (0.163625, 0.471133, 0.558148),
    (0.127568, 0.566949, 0.550556),
    (0.134692, 0.658636, 0.517649),
    (0.266941, 0.748751, 0.440573),
    (0.477504, 0.821444, 0.318195),
    (0.741388, 0.873449, 0.149561),
    (0.993248, 0.906157, 0.143936),
)


def colormap_turbo(x: torch.Tensor) -> torch.Tensor:
    """Polynomial turbo approximation (render_buffer.cu:602-617):
    x (...,) -> (..., 3)."""
    x = torch.clamp(x.float(), 0.0, 1.0)
    x2 = x * x
    x3 = x2 * x
    v4 = torch.stack([torch.ones_like(x), x, x2, x3], -1)
    v2 = torch.stack([x3 * x, x3 * x2], -1)
    k4 = torch.tensor(_TURBO_4, dtype=torch.float32, device=x.device)
    k2 = torch.tensor(_TURBO_2, dtype=torch.float32, device=x.device)
    return v4 @ k4.T + v2 @ k2.T


def colormap_viridis(x: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(_VIRIDIS_ANCHORS, dtype=torch.float32,
                         device=x.device)
    n = table.shape[0]
    x = torch.clamp(x.float(), 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(x).long(), 0, n - 2)
    f = (x - i0)[..., None]
    return table[i0] * (1 - f) + table[i0 + 1] * f


def overlay_depth(frame_rgba: torch.Tensor, depth: torch.Tensor,
                  alpha: float = 1.0, scale: float = 1.0,
                  colormap: str = "turbo") -> torch.Tensor:
    """Blend a false-colour depth visualization over a frame
    (overlay_depth_kernel): pixels with depth 0 keep the frame."""
    cm = colormap_turbo if colormap == "turbo" else colormap_viridis
    rgb = cm(depth * scale)
    a = torch.where(depth > 0, float(alpha), 0.0)[..., None]
    out_rgb = frame_rgba[..., :3] * (1 - a) + rgb * a
    return torch.cat([out_rgb, frame_rgba[..., 3:]], -1)

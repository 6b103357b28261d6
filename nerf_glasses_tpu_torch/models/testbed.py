"""Testbed — the NeRF runtime object.

Port of the rendering half of nerf_glasses_tpu/models/testbed.py
(ngp::Testbed, src/python_api.cu:301-496, src/ngp/testbed.cu):
snapshot load, occupancy, camera state and the exact render path.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io import snapshot as snap_io
from nerf_glasses_tpu_torch.io.dataset import NerfDataset
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops import raymarch
from nerf_glasses_tpu_torch.ops.colors import accumulate, tonemap_frame
from nerf_glasses_tpu_torch.ops.network import unpack_params
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox
from nerf_glasses_tpu_torch.utils.camera import fov_to_focal_length


class Testbed:
    """NeRF model + render state (ngp::Testbed(name) + load_snapshot,
    testbed.cu:57-101, 939-1002; render_frame / render_to_cpu,
    testbed.cu:1481-1612, python_api.cu:83-111)."""

    __test__ = False  # not a pytest class

    def __init__(self, name: str = "nerf", device="cuda"):
        self.name = name
        self.device = torch.device(device)
        self.config = NGPConfig()
        self.net = None
        self.density_grid = None      # (cascades, 128, 128, 128) f32 numpy
        self.occ = None               # (8, 128, 128, 128) uint8 tensor
        self._scene_version = 0
        self._scene_cache = None
        self.dataset = NerfDataset()
        self.aabb = BoundingBox([0, 0, 0], [1, 1, 1])
        self.render_aabb = self.aabb.copy()
        self.render_aabb_to_local = np.eye(3, dtype=np.float32)

        # camera state (reset_camera, testbed.cu:1383-1398)
        self.camera_matrix = np.array(
            [[1.0, 0.0, 0.0, 0.5],
             [0.0, -1.0, 0.0, 0.5],
             [0.0, 0.0, -1.0, 0.5]], np.float32)
        self._scale = 1.5
        self.camera_matrix[:, 3] -= self._scale * self.camera_matrix[:, 2]
        self.set_fov(50.625)

        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.exposure = 0.0
        self.color_space = "linear"
        self.tonemap_curve = "identity"
        self.linear_colors = False
        self.render_min_transmittance = C.DEFAULT_MIN_TRANSMITTANCE
        self._cone_angle = 0.0
        self.march_overrides = {}
        self.last_march_epochs = 0

        self._surface_rgba = None
        self._surface_t = None
        self._surface_res = None
        self._spp = 0
        self._frame_buffer = None
        self._depth_buffer = None

    # ------------------------------------------------------------------
    # Snapshot and occupancy
    # ------------------------------------------------------------------

    def load_snapshot(self, path: str):
        s = snap_io.load_snapshot(path)
        if s.config.max_cascade > 0:
            raise NotImplementedError(
                "aabb_scale > 1 (multi-cascade) scenes are not ported yet: "
                "ROADMAP.md queue 1 item 10")
        if s.config.n_extra_learnable_dims or s.extra_dims is not None:
            raise NotImplementedError(
                "latent codes (n_extra_learnable_dims) are not ported yet: "
                "ROADMAP.md queue 1 item 9")
        self.config = s.config
        self.net = unpack_params(s.params_blob, s.config, self.device)
        self.density_grid = s.density_grid
        self.dataset = s.dataset
        self.aabb = s.aabb
        self.render_aabb = s.render_aabb
        self.render_aabb_to_local = s.render_aabb_to_local
        self._cone_angle = self.config.cone_angle_constant
        self.update_occupancy()
        self.reset_accumulation()

    def update_occupancy(self):
        self.occ = occ_ops.build_occupancy(
            torch.as_tensor(self.density_grid, device=self.device),
            self.config.max_cascade)
        self._scene_version += 1

    # ------------------------------------------------------------------
    # Camera
    # ------------------------------------------------------------------

    def set_fov(self, degrees: float):
        self.relative_focal_length = np.full(
            2, fov_to_focal_length(1, degrees), np.float32)

    # ------------------------------------------------------------------
    # Rendering
    # ------------------------------------------------------------------

    def _march_options(self) -> raymarch.MarchOptions:
        kw = dict(config=self.config, cone_angle=self._cone_angle,
                  min_transmittance=self.render_min_transmittance)
        kw.update(self.march_overrides)
        return raymarch.MarchOptions(**kw)

    def _scene(self):
        """Scene tensors, rebuilt when the occupancy or render aabb
        changes (the jump grid is a dozen device ops)."""
        key = (self._scene_version, self.render_aabb.min.tobytes(),
               self.render_aabb.max.tobytes(),
               self.render_aabb_to_local.tobytes())
        if self._scene_cache is None or self._scene_cache[0] != key:
            self._scene_cache = (key, raymarch.make_scene(
                self.occ, self.render_aabb.min, self.render_aabb.max,
                self.render_aabb_to_local, self.aabb.min, self.aabb.max,
                self.device))
        return self._scene_cache[1]

    def set_surface_buffers(self, surface_rgba, t_surface, width, height):
        """Install the mesh pass's per-pixel colour and depth
        (copyRaytracingBuffersToNerfRays, nerf_mesh_renderer.cu:64-100)."""
        self._surface_rgba = surface_rgba
        self._surface_t = t_surface
        self._surface_res = (width, height)

    def reset_accumulation(self):
        self._spp = 0

    def render_frame_buffers(self, width: int, height: int,
                             sample_index: int = 0):
        """One sample -> (frame (H, W, 4) linear premultiplied, depth
        (H, W)) tensors on the device."""
        if self.net is None:
            raise RuntimeError("no snapshot loaded")
        surface_rgba = t_surface = None
        if (self._surface_rgba is not None
                and self._surface_res == (width, height)):
            surface_rgba, t_surface = self._surface_rgba, self._surface_t
        frame, depth, self.last_march_epochs = raymarch.render_image_device(
            self.net, self._scene(), self.camera_matrix, width, height,
            self._march_options(), surface_rgba, t_surface, sample_index,
            linear_colors=self.linear_colors)
        return frame, depth

    def render(self, width: int = 1920, height: int = 1080, spp: int = 1,
               linear: bool = True) -> np.ndarray:
        """Offscreen render -> (H, W, 4) float numpy (render_to_cpu,
        python_api.cu:83-111): accumulate spp samples, then tonemap
        (sRGB unless linear)."""
        self.reset_accumulation()
        accum = None
        for i in range(spp):
            frame, depth = self.render_frame_buffers(width, height, i)
            accum = accumulate(torch.zeros_like(frame) if accum is None
                               else accum, frame, i, self.color_space)
        self._depth_buffer = depth
        self._frame_buffer = frame
        out = tonemap_frame(accum, self.exposure, self.background_color,
                            self.color_space, "linear" if linear else "srgb",
                            self.tonemap_curve)
        return out.cpu().numpy()

"""NerfMeshRenderer — the hybrid NeRF + mesh orchestrator.

Port of nerf_glasses_tpu/models/renderer.py (the reference's headless
NerfMeshRenderer, src/nerf_mesh_renderer.cu). Per frame (render_frame,
nerf_mesh_renderer.cu:543-599):
  1. mesh pass at 2x supersampling, reduced 2x2 into per-pixel
     (t_surface, surface colour) payloads;
  2. each NeRF renders with the packed camera; payloads gate the march;
  3. the first NeRF's buffers are the output; others merge by nearest
     depth (combineBuffersKernel, nerf_mesh_renderer.cu:34-48);
  4. while the camera holds still, frames average progressively.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from nerf_glasses_tpu_torch.io import gltf as gltf_io
from nerf_glasses_tpu_torch.models.testbed import Testbed
from nerf_glasses_tpu_torch.ops import triangles as tri_ops
from nerf_glasses_tpu_torch.ops.colors import accumulate, tonemap_frame
from nerf_glasses_tpu_torch.utils.camera import OrbitCamera


class NerfMeshRenderer:
    """NerfMeshRenderer(width, height) (nerf_mesh_renderer.cu:365-452):
    the NeRF renders at screen size, the mesh at 2x."""

    def __init__(self, width: int = 1280, height: int = 720, device="cuda"):
        self.device = torch.device(device)
        self.SCREEN_WIDTH = width
        self.SCREEN_HEIGHT = height
        self.render_width = width
        self.render_height = height
        self.mesh_render_size_factor = 2
        self.camera = OrbitCamera()
        self.light_pos = np.array([1.0, 1.0, 1.0], np.float32)
        self.view_projection_mat = self._pack()
        self._nerfs: List[Testbed] = []
        self._meshes: List[gltf_io.GltfScene] = []
        self._mesh_arrays: Optional[tri_ops.MeshArrays] = None
        self._frame_buffer = None   # (H, W, 4) linear premultiplied
        self._depth_buffer = None
        self.progressive_accum = True
        self._accum = None
        self.last_frame_ms = 0.0

    # ------------------------------------------------------------------
    # Camera
    # ------------------------------------------------------------------

    def _pack(self) -> np.ndarray:
        return self.camera.packed(self.SCREEN_WIDTH / float(self.SCREEN_HEIGHT))

    def update_model_view_proj(self):
        """updateModelViewProj (nerf_mesh_renderer.cu:919-939)."""
        self.view_projection_mat = self._pack()
        for nerf in self._nerfs:
            nerf.camera_matrix = self.view_projection_mat.copy()
            nerf.reset_accumulation()

    def orbit(self, delta_azimuth: float, delta_polar: float,
              delta_zoom: float):
        """Orbit the camera around its pivot (nerf_mesh_renderer.cu:896-899)."""
        self.camera.orbit(delta_azimuth, delta_polar, delta_zoom)
        self.update_model_view_proj()

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    def load_nerf(self, path: str, bake: bool = False,
                  bake_resolution: int = 512, feat_resolution: int = 256,
                  verify_fidelity: bool = True,
                  verify_threshold_db: float = 30.0) -> Testbed:
        """loadNerf (nerf_mesh_renderer.cu:967-1000).

        bake=True bakes the sigma and feature grids on load and turns on
        the flash fast path. Flash drops the per-sample occupancy gate, so
        the scene gets the bake fidelity probe (Testbed.
        verify_bake_fidelity, result kept in nerf.bake_fidelity): one
        low-res frame fast vs exact; below verify_threshold_db it escalates
        (gate on -> flash off -> unbake) with a warning."""
        nerf = Testbed(os.path.splitext(os.path.basename(path))[0],
                       device=self.device)
        nerf.load_snapshot(path)
        nerf.set_fov(45.0)
        nerf.camera_matrix = self.view_projection_mat.copy()
        if bake:
            nerf.bake(bake_resolution, feat_resolution=feat_resolution)
            nerf.flash = True
            if verify_fidelity:
                nerf.bake_fidelity = nerf.verify_bake_fidelity(
                    threshold_db=verify_threshold_db)
        self._nerfs.append(nerf)
        return nerf

    def load_mesh(self, path: str, t=(0.0, 0.0, 0.0), s=(1.0, 1.0, 1.0),
                  r=(1.0, 0.0, 0.0, 0.0)) -> Optional[gltf_io.GltfScene]:
        """loadMesh (nerf_mesh_renderer.cu:941-965); `r` is a (w, x, y, z)
        quaternion. Like the reference, a mesh that fails to load is
        reported and skipped (returns None)."""
        try:
            mesh = gltf_io.load(path)
        except (OSError, ValueError, KeyError, IndexError):
            traceback.print_exc()
            return None
        mesh.nodes[0].translation = np.asarray(t, np.float32)
        mesh.nodes[0].scale = np.asarray(s, np.float32)
        mesh.nodes[0].rotation = np.asarray(r, np.float32)
        self._meshes.append(mesh)
        self._mesh_arrays = tri_ops.build_mesh_arrays(self._meshes,
                                                      self.device)
        return mesh

    def clear_meshes(self):
        self._meshes.clear()
        self._mesh_arrays = None

    # ------------------------------------------------------------------
    # Frame loop
    # ------------------------------------------------------------------

    def frame(self) -> bool:
        """Render one frame (nerf_mesh_renderer.cu:499-541). The host
        clock is read after the work is enqueued, not after it finished."""
        t0 = time.perf_counter()
        self.render_frame()
        self.last_frame_ms = (time.perf_counter() - t0) * 1000.0
        return True

    def render_frame(self):
        w, h = self.render_width, self.render_height
        if self._mesh_arrays is not None and self._nerfs:
            xf, nm = tri_ops.instance_transforms(self._mesh_arrays,
                                                 self._meshes)
            surf_c, surf_t = tri_ops.render_mesh_surface(
                self._mesh_arrays, xf, nm, self.view_projection_mat, w, h,
                self.mesh_render_size_factor, self.light_pos)
            self._nerfs[0].set_surface_buffers(
                surf_c.reshape(-1, 4), surf_t.reshape(-1), w, h)
        elif self._nerfs:
            self._nerfs[0].set_surface_buffers(None, None, w, h)

        if not self._nerfs:
            self._frame_buffer = torch.zeros((h, w, 4), device=self.device)
            self._depth_buffer = torch.zeros((h, w), device=self.device)
            return

        buffers = []
        for nerf in self._nerfs:
            nerf.camera_matrix = self.view_projection_mat.copy()
            buffers.append(nerf.render_frame_buffers(w, h,
                                                     sample_index=nerf._spp))
            nerf._spp += 1
        frame, depth = buffers[0]
        for fb, db in buffers[1:]:
            closer = db < depth
            frame = torch.where(closer[..., None], fb, frame)
            depth = torch.where(closer, db, depth)
        self._frame_buffer = frame
        self._depth_buffer = depth

        # progressive accumulation, keyed on the first NeRF's sample
        # count, which camera movement resets (render_buffer.cu:232-268)
        if self.progressive_accum:
            spp = self._nerfs[0]._spp - 1
            if spp <= 0 or self._accum is None:
                spp = 0
            self._accum = accumulate(
                torch.zeros_like(frame) if spp == 0 else self._accum,
                frame, spp, self._nerfs[0].color_space)
        else:
            self._accum = None

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------

    def display_image(self, tonemap: bool = True) -> np.ndarray:
        """Tonemapped composited frame -> (H, W, 4) float numpy sRGB."""
        if self._frame_buffer is None:
            self.render_frame()
        fb = (self._accum if self.progressive_accum and self._accum is not None
              else self._frame_buffer)
        nerf = self._nerfs[0] if self._nerfs else None
        bg = (nerf.background_color if nerf is not None
              else np.array([1.0, 1, 1, 1], np.float32))
        out = tonemap_frame(fb, nerf.exposure if nerf else 0.0, bg,
                            nerf.color_space if nerf else "linear",
                            "srgb" if tonemap else "linear",
                            nerf.tonemap_curve if nerf else "identity")
        return out.cpu().numpy()

    def save_frame(self, path: str):
        from PIL import Image
        img = self.display_image()
        arr = np.clip(img[::-1, :, :3] * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(path)

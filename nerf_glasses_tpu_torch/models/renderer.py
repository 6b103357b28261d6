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

Around the frame: the envmap background and the depth overlay of
display_image, stats(), density-grid dump/load, floaty removal, collide
(gravity-style settling of a mesh on the NeRF) and the camera trajectory
recorder. The entry points that touch the network run under
torch.no_grad(): grad mode is per thread, and the viewer calls them from
handler threads.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from nerf_glasses_tpu_torch.io import gltf as gltf_io
from nerf_glasses_tpu_torch.models import floaty
from nerf_glasses_tpu_torch.models.testbed import Testbed
from nerf_glasses_tpu_torch.ops import triangles as tri_ops
from nerf_glasses_tpu_torch.ops.colormaps import overlay_depth
from nerf_glasses_tpu_torch.ops.colors import accumulate, tonemap_frame
from nerf_glasses_tpu_torch.ops.raymarch import camera_rays
from nerf_glasses_tpu_torch.utils.camera import OrbitCamera
from nerf_glasses_tpu_torch.utils.meters import Ema, device_memory_stats


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
        self._envmap: Optional[np.ndarray] = None
        self._frame_buffer = None   # (H, W, 4) linear premultiplied
        self._depth_buffer = None
        # depth visualization overlay (the reference's overlay_depth
        # render-buffer mode, render_buffer.cu:421-535)
        self.visualize_depth = False
        self.depth_overlay_alpha = 1.0
        self.depth_overlay_scale = 1.0
        self.depth_colormap = "turbo"
        self.progressive_accum = True
        self._accum = None
        self._frame_count = 0
        self._fps_t0 = time.monotonic()
        self._fps_frames = 0
        self.fps = 0.0
        self._closed = False
        # host-clock meters of frame() (Testbed::m_frame_ms): the time to
        # enqueue a frame unless `profile` is on or the caller drains
        self.frame_ms = Ema("time", 1000.0)
        self.render_ms = Ema("time", 1000.0)
        self.last_frame_ms = 0.0
        # opt-in per-phase times: drains the device after the mesh pass
        # and after the NeRF pass, which costs their overlap
        self.profile = False
        self.mesh_ms = Ema("time", 1000.0)
        self.nerf_ms = Ema("time", 1000.0)

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
            nerf.reset_accumulation(True)

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
        self._rebuild_mesh_arrays()
        return mesh

    def _rebuild_mesh_arrays(self):
        self._mesh_arrays = tri_ops.build_mesh_arrays(self._meshes,
                                                      self.device)

    def clear_meshes(self):
        self._meshes.clear()
        self._mesh_arrays = None

    def clear_nerfs(self):
        self._nerfs.clear()

    def envmap(self, path: str):
        """Set a lat-long environment map as the render background
        (render.py:228 calls this; mapping per latlong_to_dir,
        ngp_common.cuh:292-299)."""
        from PIL import Image
        img = Image.open(path).convert("RGB")
        self._envmap = np.asarray(img, np.float32) / 255.0  # sRGB

    # ------------------------------------------------------------------
    # Frame loop
    # ------------------------------------------------------------------

    def frame(self) -> bool:
        """Render one frame (nerf_mesh_renderer.cu:499-541) -> True until
        close(). The host clock is read after the work is enqueued, not
        after it finished: frame_ms, render_ms and fps are enqueue times
        unless `profile` drains the device or the caller synchronizes."""
        if self._closed:
            return False
        t0 = time.perf_counter()
        self.render_frame()
        self.last_frame_ms = (time.perf_counter() - t0) * 1000.0
        self.render_ms.update(self.last_frame_ms)
        self.frame_ms.update(self.last_frame_ms)
        self._frame_count += 1
        self._fps_frames += 1
        now = time.monotonic()
        if now - self._fps_t0 >= 1.0:
            self.fps = self._fps_frames / (now - self._fps_t0)
            self._fps_frames = 0
            self._fps_t0 = now
        return True

    def close(self):
        self._closed = True

    def _drain(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def render_frame(self):
        w, h = self.render_width, self.render_height
        t_mesh0 = time.perf_counter() if self.profile else 0.0
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
        if self.profile:
            self._drain()
            self.mesh_ms.update((time.perf_counter() - t_mesh0) * 1000.0)

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
        if self.profile:
            self._drain()
            self.nerf_ms.update((time.perf_counter() - t_mesh0) * 1000.0
                                - self.mesh_ms.val)
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

    def stats(self) -> dict:
        """Live render statistics, the headless form of the reference's
        stats panel (FPS / frame-ms / VRAM, nerf_mesh_renderer.cu:829-874).
        The hbm_* keys keep the JAX package's names and report this
        renderer's device (PyTorch's allocator on a CUDA device; unavailable
        and 0 on the CPU); mesh_ms and nerf_ms fill when `profile` is on."""
        mem = device_memory_stats(self.device)
        return {
            "fps": self.fps,
            "frame_ms": self.frame_ms.ema_val,
            "mesh_ms": self.mesh_ms.ema_val,
            "nerf_ms": self.nerf_ms.ema_val,
            "hbm_available": mem["available"],
            "hbm_bytes_in_use": mem["bytes_in_use"],
            "hbm_bytes_limit": mem["bytes_limit"],
            "hbm_peak_bytes_in_use": mem["peak_bytes_in_use"],
            "n_nerfs": len(self._nerfs),
            "n_meshes": len(self._meshes),
            "frame_count": self._frame_count,
            # the march path the first NeRF's last render took
            "render_path": (self._nerfs[0].last_render_path
                            if self._nerfs else None),
        }

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------

    @torch.no_grad()
    def display_image(self, tonemap: bool = True) -> np.ndarray:
        """Tonemapped composited frame -> (H, W, 4) float numpy sRGB."""
        if self._frame_buffer is None:
            self.render_frame()
        fb = (self._accum if self.progressive_accum and self._accum is not None
              else self._frame_buffer)
        nerf = self._nerfs[0] if self._nerfs else None
        bg = (nerf.background_color if nerf is not None
              else np.array([1.0, 1, 1, 1], np.float32))
        if self._envmap is not None:
            bg = self._background_from_envmap()
        out = tonemap_frame(fb, nerf.exposure if nerf else 0.0, bg,
                            nerf.color_space if nerf else "linear",
                            "srgb" if tonemap else "linear",
                            nerf.tonemap_curve if nerf else "identity")
        if self.visualize_depth and self._depth_buffer is not None:
            out = overlay_depth(out, self._depth_buffer,
                                self.depth_overlay_alpha,
                                self.depth_overlay_scale, self.depth_colormap)
        return out.cpu().numpy()

    def _background_from_envmap(self) -> np.ndarray:
        """Per-pixel sRGB background sampled from the lat-long envmap."""
        _, d = camera_rays(self.view_projection_mat, self.render_width,
                           self.render_height)
        theta = np.arcsin(np.clip(d[:, 1], -1.0, 1.0))
        phi = np.arctan2(d[:, 0], d[:, 2])
        v = theta / np.pi + 0.5
        u = phi / (2 * np.pi) + 0.5
        eh, ew = self._envmap.shape[:2]
        xi = np.clip((u * ew).astype(int), 0, ew - 1)
        yi = np.clip(((1.0 - v) * eh).astype(int), 0, eh - 1)
        rgb = self._envmap[yi, xi]
        rgba = np.concatenate([rgb, np.ones((len(rgb), 1), np.float32)], -1)
        return rgba.reshape(self.render_height, self.render_width, 4)

    def save_frame(self, path: str):
        from PIL import Image
        img = self.display_image()
        arr = np.clip(img[::-1, :, :3] * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(path)

    # ------------------------------------------------------------------
    # Density-grid dump / load (nerf_mesh_renderer.cu:239-358)
    # ------------------------------------------------------------------

    def dump_density_grid(self, nerf_index: int = 0) -> np.ndarray:
        """-> (8, 128, 128, 128) uint8 0/1 in [mip, z, y, x] layout with x
        fastest: byte for byte the reference's dump file
        (x + 128*(y + 128*(z + 128*mip))). The first NeRF by default, as
        in the reference (nerf_mesh_renderer.cu:901-917). One 16 MiB
        fetch from the device."""
        return (self._nerfs[nerf_index].occ > 0).to(torch.uint8).cpu().numpy()

    def load_density_grid_array(self, grid: np.ndarray, nerf_index: int = 0):
        """Install an occupancy grid; the NeRF's memoized scene (its jump
        grid, the flash splat points) is rebuilt on the next frame."""
        occ = (np.asarray(grid).reshape(8, 128, 128, 128) > 0).astype(np.uint8)
        self._nerfs[nerf_index].occ = torch.as_tensor(occ, device=self.device)

    def dump_density_grid_file(self, filename: str):
        with open(filename, "wb") as f:
            f.write(self.dump_density_grid().tobytes())

    def load_density_grid_file(self, filename: str):
        with open(filename, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        self.load_density_grid_array(data)

    # ------------------------------------------------------------------
    # Floaty removal (removeFloaties, nerf_mesh_renderer.cu:901-917)
    # ------------------------------------------------------------------

    def remove_floaties(self):
        """Keep the occupancy grid's main cluster (models/floaty.py, host
        code); -> the cluster count. A baked Testbed keeps its baked sigma
        grid, which was masked by the grid of bake time."""
        t0 = time.perf_counter()
        cleaned, n_clusters = floaty.remove_floaties(self.dump_density_grid())
        self.load_density_grid_array(cleaned)
        dt = (time.perf_counter() - t0) * 1000.0
        # the reference printf's the cluster count and the elapsed time
        print(f"{n_clusters}   {dt:.3f} ms", file=sys.stderr)
        return n_clusters

    # ------------------------------------------------------------------
    # Collide: gravity-style settling of a mesh against the NeRF
    # (NerfMeshRenderer::collide, nerf_mesh_renderer.cu:1548-1786)
    # ------------------------------------------------------------------

    def collide(self, direction, node: gltf_io.GltfNode) -> bool:
        """One settling step of `node` along `direction` -> True at rest.
        No contact yet: translate to the first density hit. In contact
        with the centroid over the contact hull: at rest. Otherwise tip
        by half a degree around one or two contact points."""
        direction = np.asarray(direction, np.float32)
        vertices = node.vertices_facing_direction(-direction)
        if len(vertices) == 0:
            return False
        nerf = self._nerfs[0]
        xform = node.get_transform()
        world = vertices @ xform[:3, :3].T + xform[:3, 3]
        ngp_pts = world + 0.5  # renderer world -> NGP cube

        centroid_local = node.centroid()
        global_centroid = xform[:3, :3] @ centroid_local + xform[:3, 3]
        gc_xz = global_centroid[[0, 2]]

        # which vertices already intersect the NeRF
        inter = nerf.alpha_at(ngp_pts) > 0.0

        if not inter.any():
            # march all vertices along `direction` to first density hit
            dists = nerf.collide_distances(ngp_pts, direction)
            shortest = float(np.min(dists))
            node.translation = (node.translation
                                + direction * shortest).astype(np.float32)
            return False

        local_pts = vertices[inter]
        g_xz = world[inter][:, [0, 2]]

        if len(local_pts) >= 3:
            hull = _graham_scan(g_xz)
            if _point_inside_hull(hull, gc_xz):
                return True  # at rest

        # tip around one or two contact points
        d_c = np.linalg.norm(g_xz - gc_xz, axis=1)
        i0 = int(np.argmin(d_c))
        first_xz = g_xz[i0]
        t1 = local_pts[i0]

        t2 = None
        best_angle = 42.0
        for i in range(len(g_xz)):
            v = g_xz[i] - first_xz
            if np.linalg.norm(v) < 0.1:
                continue
            middle = (first_xz + g_xz[i]) / 2.0
            to_centroid = gc_xz - middle
            denom = np.linalg.norm(v) * np.linalg.norm(to_centroid)
            angle = np.arccos(np.clip(np.dot(v, to_centroid)
                                      / max(denom, 1e-12), -1, 1))
            diff = abs(angle - np.pi / 2)
            proj = np.dot(gc_xz - first_xz, v) / max(np.dot(v, v), 1e-12)
            between = 0 < proj < 1
            if not between and diff > np.pi / 4:
                continue
            if diff < best_angle:
                best_angle = diff
                t2 = local_pts[i]

        if t2 is None:
            axis = np.cross(_normalize(centroid_local - t1), direction)
            node.rotate_around_axis(_normalize(axis), t1, 0.5)
            return False

        axis = _normalize(t2 - t1)
        sgn = 1.0 if np.cross(_normalize(centroid_local - t1), axis)[1] > 0 \
            else -1.0
        node.rotate_around_axis(axis, t1, sgn * 0.5)
        return False

    # ------------------------------------------------------------------
    # Camera trajectory recorder (gui(), nerf_mesh_renderer.cu:630-660)
    # ------------------------------------------------------------------

    def record_trajectory(self, distance: float = 1.1, height: float = 0.1,
                          start_angle: float = 0.5, end_angle: float = 2.5,
                          num_images: int = 10, lookat=(0.0, 0.0, 0.0),
                          out_dir: str = "."):
        """Render frames along a circular path, writing trajectory_N.jpg
        plus transform_N camera files."""
        lookat = np.asarray(lookat, np.float32)
        angle = start_angle
        idx = 1
        while angle < end_angle:
            angle += (end_angle - start_angle) / num_images
            eye = np.array([np.cos(angle) * distance, height,
                            np.sin(angle) * distance], np.float32)
            self.camera.eye = eye
            self.camera.look = _normalize(lookat - eye)
            self.update_model_view_proj()
            self.frame()
            self.save_frame(os.path.join(out_dir, f"trajectory_{idx}.jpg"))
            with open(os.path.join(out_dir, f"transform_{idx}"), "w") as f:
                rows = [
                    "[" + ", ".join(repr(float(v)) for v in row) + "]"
                    for row in self.view_projection_mat]
                f.write("[" + ",\n".join(rows) + "]")
            idx += 1

    # reference-name aliases (pynmr camelCase quirks)
    loadNerf = load_nerf
    loadMesh = load_mesh
    removeFloaties = remove_floaties
    updateModelViewProj = update_model_view_proj
    dumpDensityGrid = dump_density_grid


def _normalize(v):
    v = np.asarray(v, np.float64)
    return (v / max(np.linalg.norm(v), 1e-12)).astype(np.float32)


def _graham_scan(points_xz: np.ndarray) -> np.ndarray:
    """2D convex hull (the reference uses a Graham scan,
    nerf_mesh_renderer.cu:1615-1635)."""
    pts = sorted(set(tuple(p) for p in np.asarray(points_xz, np.float64)))
    if len(pts) <= 2:
        return np.asarray(pts)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def chain(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out[:-1]

    return np.asarray(chain(pts) + chain(reversed(pts)))


def _point_inside_hull(hull: np.ndarray, point: np.ndarray) -> bool:
    """Same-side test (pointInsideHull, nerf_mesh_renderer.cu:1636-1652)."""
    n = len(hull)
    if n < 3:
        return False
    sign = 0.0
    for i in range(n):
        p1 = hull[i]
        edge = hull[(i + 1) % n] - p1
        to_p = np.asarray(point) - p1
        c = edge[0] * to_p[1] - edge[1] * to_p[0]
        if c != 0:
            if sign == 0:
                sign = np.sign(c)
            elif np.sign(c) != sign:
                return False
    return True

"""Testbed — the NeRF runtime object.

Port of nerf_glasses_tpu/models/testbed.py (ngp::Testbed,
src/python_api.cu:301-496, src/ngp/testbed.cu): snapshot load and save,
occupancy, camera state, the `nerf` render settings, the exact render
path, the baked fast path (bake, flash, deferred shading, the bake
fidelity probe), each for one cascade or several (aabb_scale > 1),
density queries (density_at, alpha_at, collide_distances), the camera helpers
and crop box, the camera features (lens distortion from the dataset's
first camera and the trained distortion map, pixel-centre snapping,
depth of field, the rolling-shutter render), latent codes, and the
pyngp-style training surface (load_training_data, shall_train + frame(),
train, sync_from_trainer).

The render and query entry points run under torch.no_grad(): a Testbed
that trains renders its trainer's live network, whose parameters require
gradients, and grad mode is per thread (the viewer renders in handler
threads).
"""

from __future__ import annotations

import dataclasses
import sys
import warnings

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io import snapshot as snap_io
from nerf_glasses_tpu_torch.io import dataset as ds_io
from nerf_glasses_tpu_torch.io.dataset import NerfDataset
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops import raymarch
from nerf_glasses_tpu_torch.ops.bake import bake_grids, bake_grids_cascades
from nerf_glasses_tpu_torch.ops.colors import accumulate, tonemap_frame
from nerf_glasses_tpu_torch.ops.network import (apply_density_activation,
                                                init_params, pack_params,
                                                unpack_params)
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox
from nerf_glasses_tpu_torch.utils.camera import fov_to_focal_length


class NerfRenderSettings:
    """The `testbed.nerf` sub-object (python_api.cu:479-496). `sharpen` is
    the unsharp-mask amount set_training_image applies
    (nerf_loader.cu:811-833); `render_min_transmittance` ends a ray's
    march; the activations and the cone angle live on the Testbed's
    config and march options; `visualize_cameras`, `glow_y_cutoff` and
    `glow_mode` are kept for scripts and do nothing, as in the reference
    fork. `render_with_lens_distortion` renders through the dataset's
    first camera's lens and the Testbed's distortion_map."""

    def __init__(self, testbed: "Testbed"):
        self._tb = testbed
        self.sharpen = 0.0
        self.render_with_lens_distortion = False
        self.render_min_transmittance = C.DEFAULT_MIN_TRANSMITTANCE
        self.visualize_cameras = False
        self.glow_y_cutoff = 0.0
        self.glow_mode = 0

    @property
    def rgb_activation(self):
        return self._tb.config.rgb_activation

    @rgb_activation.setter
    def rgb_activation(self, v):
        self._tb.config = _replace_cfg(self._tb.config,
                                       rgb_activation=_act(v))

    @property
    def density_activation(self):
        return self._tb.config.density_activation

    @density_activation.setter
    def density_activation(self, v):
        self._tb.config = _replace_cfg(self._tb.config,
                                       density_activation=_act(v))

    @property
    def cone_angle_constant(self):
        return self._tb._cone_angle

    @cone_angle_constant.setter
    def cone_angle_constant(self, v):
        self._tb._cone_angle = float(v)

    # legacy alias
    rendering_min_transmittance = property(
        lambda self: self.render_min_transmittance)

    @property
    def training(self):
        return self._tb._training_view

    @property
    def render_aabb(self):
        return self._tb.render_aabb

    @render_aabb.setter
    def render_aabb(self, v):
        self._tb.render_aabb = v


class _TrainingView:
    """Read-only `testbed.nerf.training` view (dataset metadata)."""

    def __init__(self, tb):
        self._tb = tb

    @property
    def dataset(self):
        return self._tb.dataset

    @property
    def linear_colors(self):
        return self._tb.linear_colors

    @linear_colors.setter
    def linear_colors(self, v):
        self._tb.linear_colors = bool(v)


def _replace_cfg(cfg: NGPConfig, **kw) -> NGPConfig:
    return dataclasses.replace(cfg, **kw)


def _act(v) -> str:
    """An activation's name from a string or an enum-like value."""
    return v if isinstance(v, str) else str(v).split(".")[-1].lower()


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
        # the occupancy and the baked sigma grid bump _scene_version when
        # assigned, so the memoized scene keys on a counter
        self._scene_version = 0
        self._occ = None              # (8, 128, 128, 128) uint8 tensor
        self._scene_cache = None
        self._extra_dims = None        # inference latent codes (E,)
        self.dataset = NerfDataset()
        self.aabb = BoundingBox([0, 0, 0], [1, 1, 1])
        self.raw_aabb = self.aabb.copy()
        self.render_aabb = self.aabb.copy()
        self.render_aabb_to_local = np.eye(3, dtype=np.float32)
        self.bounding_radius = 1.0
        self.training_step = 0
        self.loss = 0.0
        self.nerf = NerfRenderSettings(self)
        self._training_view = _TrainingView(self)
        self.shall_train = False
        self._trainer = None

        # camera state (reset_camera, testbed.cu:1383-1398)
        self.camera_matrix = np.array(
            [[1.0, 0.0, 0.0, 0.5],
             [0.0, -1.0, 0.0, 0.5],
             [0.0, 0.0, -1.0, 0.5]], np.float32)
        self._scale = 1.5
        self.camera_matrix[:, 3] -= self._scale * self.view_dir
        self.smoothed_camera = self.camera_matrix.copy()
        self.up_dir = np.array([0.0, 1.0, 0.0], np.float32)
        self.sun_dir = np.ones(3, np.float32) / np.sqrt(3)
        self.fov_axis = 1
        self.zoom = 1.0
        self.screen_center = np.array([0.5, 0.5], np.float32)
        self.set_fov(50.625)
        # GUI state kept for scripts; as in the reference fork, the
        # windowless render path never acts on it (python_api.cu:435-442)
        self.camera_smoothing = False
        self.parallax_shift = np.zeros(3, np.float32)
        self.visualized_dimension = -1
        self.visualized_layer = 0
        self.max_level_rand_training = False
        self.fixed_res_factor = 8
        self.display_gui = False
        self.visualize_unit_cube = False
        # camera features: pinned pixel centres (no per-sample offsets),
        # depth of field (pixel_to_ray's aperture, ngp_common.cuh:330-345)
        # and the trained distortion map (Hg, Wg, 2) that
        # nerf.render_with_lens_distortion adds to the ray directions
        self.snap_to_pixel_centers = False
        self.aperture_size = 0.0
        self.focus_z = 1.0
        self.distortion_map = None

        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.exposure = 0.0
        self.color_space = "linear"
        self.tonemap_curve = "identity"
        self.linear_colors = False
        self._cone_angle = 0.0
        self.march_overrides = {}
        self.last_march_epochs = 0
        self.last_collide_turns = 0
        self.last_render_path = None   # set by render_frame_buffers
        self._warned_flash_fallback = False

        # baked fast path (bake()): the dense sigma grid, the feature grid
        self._baked_sigma_arr = None
        self._baked_feat = None
        self._baked_sigma_log = False
        # deferred shading: one colour evaluation per ray at its max-weight
        # sample (MarchOptions.deferred_color)
        self.deferred_shading = False
        # flash: deferred shading + coarse init + vector rounds
        self.flash = False
        # (psnr_db, action) of the bake fidelity probe NerfMeshRenderer.
        # load_nerf(bake=True) ran, or None
        self.bake_fidelity = None

        self._surface_rgba = None
        self._surface_t = None
        self._surface_res = None
        self._spp = 0
        self._frame_buffer = None
        self._depth_buffer = None

    @property
    def render_min_transmittance(self):
        """Alias of nerf.render_min_transmittance."""
        return self.nerf.render_min_transmittance

    @render_min_transmittance.setter
    def render_min_transmittance(self, v):
        self.nerf.render_min_transmittance = v

    @property
    def occ(self):
        return self._occ

    @occ.setter
    def occ(self, v):
        self._occ = v
        self._scene_version += 1

    @property
    def _baked_sigma(self):
        return self._baked_sigma_arr

    @_baked_sigma.setter
    def _baked_sigma(self, v):
        # the memoized scene carries the baked grids
        self._baked_sigma_arr = v
        self._scene_version += 1

    @property
    def extra_dims(self):
        return self._extra_dims

    @extra_dims.setter
    def extra_dims(self, v):
        # the memoized scene carries the latent codes
        self._extra_dims = v
        self._scene_version += 1

    # ------------------------------------------------------------------
    # Snapshot and occupancy
    # ------------------------------------------------------------------

    def load_snapshot(self, path: str):
        s = snap_io.load_snapshot(path)
        self.config = s.config
        self.net = unpack_params(s.params_blob, s.config, self.device)
        self.density_grid = s.density_grid
        self.dataset = s.dataset
        self.aabb = s.aabb
        self.raw_aabb = s.aabb.copy()
        self.render_aabb = s.render_aabb
        self.render_aabb_to_local = s.render_aabb_to_local
        self.bounding_radius = s.bounding_radius
        self.training_step = s.training_step
        self.loss = s.loss
        self.extra_dims = s.extra_dims
        self._cone_angle = self.config.cone_angle_constant
        self.up_dir = s.dataset.up.copy()
        self.update_occupancy()
        self.reset_accumulation()

    def save_snapshot(self, path: str, include_optimizer_state: bool = False):
        """The pyngp signature; the format carries the parameters (and
        the inference latent codes) only, so include_optimizer_state
        changes nothing."""
        snap_io.save_snapshot(
            path, self.config, pack_params(self.net).astype(np.float32),
            self.density_grid, self.dataset, self.aabb, self.render_aabb,
            self.render_aabb_to_local, self.bounding_radius,
            self.training_step, self.loss, extra_dims=self.extra_dims)

    def update_occupancy(self):
        self.occ = occ_ops.build_occupancy(
            torch.as_tensor(self.density_grid, device=self.device),
            self.config.max_cascade)

    # ------------------------------------------------------------------
    # Camera helpers (testbed.cu:1319-1401)
    # ------------------------------------------------------------------

    @property
    def view_pos(self):
        return self.camera_matrix[:, 3]

    @property
    def view_dir(self):
        return self.camera_matrix[:, 2]

    @property
    def look_at(self):
        return self.view_pos + self.view_dir * self._scale

    @look_at.setter
    def look_at(self, pos):
        self.camera_matrix[:, 3] += np.asarray(pos, np.float32) - self.look_at

    @property
    def view_dir_prop(self):
        return self.view_dir

    def set_view_dir(self, dir):
        d = np.asarray(dir, np.float64)
        old_look_at = self.look_at.copy()
        x = np.cross(d, self.up_dir)
        self.camera_matrix[:, 0] = x / np.linalg.norm(x)
        y = np.cross(d, self.camera_matrix[:, 0])
        self.camera_matrix[:, 1] = y / np.linalg.norm(y)
        self.camera_matrix[:, 2] = d / np.linalg.norm(d)
        self.look_at = old_look_at

    @property
    def scale(self):
        return self._scale

    @scale.setter
    def scale(self, scale):
        prev_look_at = self.look_at.copy()
        self.camera_matrix[:, 3] = ((self.view_pos - prev_look_at)
                                    * (scale / self._scale) + prev_look_at)
        self._scale = scale

    def set_fov(self, degrees: float):
        self.relative_focal_length = np.full(
            2, fov_to_focal_length(1, degrees), np.float32)

    def translate_camera(self, rel):
        self.camera_matrix[:, 3] += (
            self.camera_matrix[:, :3] @ np.asarray(rel, np.float32)
            * self.bounding_radius)
        self.reset_accumulation()

    # crop box (testbed.cu:1422-1477)
    def crop_box(self, nerf_space: bool = True) -> np.ndarray:
        cen = self.render_aabb_to_local.T @ self.render_aabb.center()
        radius = self.render_aabb.diag() * 0.5
        rv = np.zeros((3, 4), np.float32)
        rv[:, 0] = self.render_aabb_to_local[0] * radius[0]
        rv[:, 1] = self.render_aabb_to_local[1] * radius[1]
        rv[:, 2] = self.render_aabb_to_local[2] * radius[2]
        rv[:, 3] = cen
        if nerf_space:
            rv = ds_io.ngp_matrix_to_nerf(rv, self.dataset.scale,
                                          self.dataset.offset,
                                          self.dataset.from_mitsuba, True)
        return rv

    def set_crop_box(self, m: np.ndarray, nerf_space: bool = True):
        m = np.asarray(m, np.float32)
        if nerf_space:
            m = ds_io.nerf_matrix_to_ngp(m, self.dataset.scale,
                                         self.dataset.offset,
                                         self.dataset.from_mitsuba, True)
        radius = np.linalg.norm(m[:, :3], axis=0)
        cen = m[:, 3]
        for i in range(3):
            self.render_aabb_to_local[i] = m[:, i] / radius[i]
        cen = self.render_aabb_to_local @ cen
        self.render_aabb = BoundingBox(cen - radius, cen + radius)

    def crop_box_corners(self, nerf_space: bool = True):
        m = self.crop_box(nerf_space)
        corners = []
        for i in range(8):
            v = np.array([1.0 if i & 1 else -1.0,
                          1.0 if i & 2 else -1.0,
                          1.0 if i & 4 else -1.0, 1.0], np.float32)
            corners.append(m @ v)
        return corners

    # ------------------------------------------------------------------
    # Rendering
    # ------------------------------------------------------------------

    def _march_options(self) -> raymarch.MarchOptions:
        kw = dict(config=self.config, cone_angle=self._cone_angle,
                  min_transmittance=self.nerf.render_min_transmittance)
        multi = self.config.max_cascade > 0
        if multi:
            # Every multi-cascade path, the exact one included, advances
            # on the clearance pyramid (march_cuda._dist_probe_mips), and
            # not for speed: the reference's init walk is unbounded, so
            # each ray settles at its first occupied cell and a ray that
            # settles inside mip 0 gets t_start there, which switches it
            # to fine (t - t_start) cone steps and mip-0 gating
            # (testbed.cu:502-537). A bounded per-voxel walk rarely
            # settles, t_start stays 0, and the march gates at coarse
            # absolute-t mips: opaque phantom silhouettes one pooled cell
            # wide. Clearance hops settle the walk in a few iterations.
            kw["dist_advance"] = True
        if self._baked_sigma is not None:
            kw["use_baked_sigma"] = True
            kw["baked_sigma_log"] = self._baked_sigma_log
            if self.deferred_shading:
                kw["deferred_color"] = True
            if self.flash and multi:
                # the JAX package's multi-cascade flash bundle: deferred
                # shade from the feature pyramid, vector 16-sample rounds
                # (a per-ray dt, constant within the round), the voxel
                # splat over every cascade's occupied centres. The
                # per-sample occupancy gate stays on: its mip is what
                # keeps a sample in the cascade the bake masked.
                kw.update(deferred_color=True, vector_rounds=True,
                          steps_per_round=16, chunk=1 << 11,
                          lowres_factor=8, advance_iters=24)
            elif self.flash:
                # the JAX package's single-cascade flash bundle: deferred
                # shading, coarse init, vector 16-sample rounds, a 24-step
                # advance so silhouette-grazing rays walk clear of the
                # baked grid's dilated shell, no per-sample occupancy gate
                # (the bake fidelity probe turns it back on where needed)
                kw.update(deferred_color=True, lowres_factor=8,
                          advance_iters=24, vector_rounds=True,
                          steps_per_round=16, chunk=1 << 11,
                          vector_occ_gate=False)
        if self.aperture_size > 0.0:
            kw.update(aperture_size=float(self.aperture_size),
                      focus_z=float(self.focus_z))
        kw.update(self.march_overrides)
        return raymarch.MarchOptions(**kw)

    def _scene(self):
        """Scene tensors, rebuilt when the occupancy, the render aabb or
        the bake changes (the jump grid is a dozen device ops, the
        clearance grids 30 dilation rounds)."""
        key = (self._scene_version, self.render_aabb.min.tobytes(),
               self.render_aabb.max.tobytes(),
               self.render_aabb_to_local.tobytes())
        if self._scene_cache is None or self._scene_cache[0] != key:
            scene = raymarch.make_scene(
                self.occ, self.render_aabb.min, self.render_aabb.max,
                self.render_aabb_to_local, self.aabb.min, self.aabb.max,
                self.device)
            n_casc = self.config.max_cascade + 1
            if n_casc == 1:
                scene["dist"] = occ_ops.build_dist_grid(scene["occ"])
            else:
                scene["dist_mips"] = occ_ops.build_dist_grid_cascades(
                    scene["occ"], self.config.max_cascade)
            if self._baked_sigma is not None:
                scene["sigma"] = self._baked_sigma
                if self._baked_feat is not None:
                    scene["feat"] = self._baked_feat
                # The flash voxel splat's points: the occupied voxel
                # centres of every cascade in raw coordinates (cascade
                # c's cube has side 2^c about 0.5; (casc, z, y, x) rows).
                # With several cascades each point's depth is padded by
                # its voxel's half diagonal (raymarch.flash_init).
                idx = torch.nonzero(scene["occ"][:n_casc] > 0)
                side = torch.exp2(idx[:, 0].float())
                local = (idx[:, 1:].flip(-1).float() + 0.5) / C.NERF_GRIDSIZE
                if n_casc == 1:
                    scene["occ_pts"] = local
                elif idx.shape[0]:
                    scene["occ_pts"] = (local - 0.5) * side[:, None] + 0.5
                    scene["occ_pts_pad"] = side * float(
                        np.sqrt(3.0) / (2.0 * C.NERF_GRIDSIZE))
            if (self.config.n_extra_learnable_dims
                    and self.extra_dims is not None):
                # inference latent codes (get_inference_extra_dims,
                # testbed.cu:1614-1631)
                scene = raymarch.scene_with_extra_dims(scene, self.extra_dims)
            self._scene_cache = (key, scene)
        return self._scene_cache[1]

    @torch.no_grad()
    def bake(self, resolution: int = 256, features: bool = True,
             feat_resolution: int = None, sigma_log: bool = True):
        """Bake the density field (and, with features, the density MLP's
        16-wide output) to dense grids for the fast path (ops/bake.py).
        feat_resolution defaults to min(resolution, 256): the features vary
        smoothly, and a 512^3 bf16 feature grid would take 4.3 GB. A scene
        with aabb_scale > 1 bakes one grid of each kind per cascade, each
        over its own 2^c cube (bake_grids_cascades)."""
        act = self.config.density_activation
        if self.config.max_cascade != 0:
            grid, feat = bake_grids_cascades(
                self.net, resolution, occ=self.occ, log_space=sigma_log,
                aabb=(self.aabb.min, self.aabb.max), features=features,
                feat_resolution=feat_resolution, density_activation=act)
            self._baked_feat = feat
            self._baked_sigma_log = sigma_log
            self._baked_sigma = grid
            self.reset_accumulation()
            return
        if feat_resolution is None:
            feat_resolution = min(resolution, 256)
        same = feat_resolution == resolution
        grid, feat = bake_grids(self.net, resolution, occ=self.occ,
                                features=features and same,
                                log_space=sigma_log, density_activation=act)
        if features and not same:
            _, feat = bake_grids(self.net, feat_resolution, occ=self.occ,
                                 features=True)
        self._baked_feat = feat
        self._baked_sigma_log = sigma_log
        self._baked_sigma = grid
        self.reset_accumulation()

    def unbake(self):
        self._baked_feat = None
        self._baked_sigma = None
        self._baked_sigma_log = False

    def adopt_bake(self, other: "Testbed"):
        """Share another Testbed's baked grids (read-only tensors, a pure
        function of the params and resolution): one bake per snapshot."""
        self._baked_feat = other._baked_feat
        self._baked_sigma_log = other._baked_sigma_log
        self._baked_sigma = other._baked_sigma
        self.reset_accumulation()

    @torch.no_grad()
    def verify_bake_fidelity(self, width: int = 160, height: int = 160,
                             threshold_db: float = 30.0, camera=None) -> tuple:
        """Probe the baked/flash path against the exact render on one
        low-res frame -> (psnr_db, action). Below `threshold_db` it
        escalates, warning at each step that fires:
          1. re-enable the per-sample occupancy gate (vector_occ_gate),
          2. drop flash, keep the baked sigma grid,
          3. unbake (exact path).
        `camera` defaults to the snapshot's first training view, else the
        current camera. `action` is "ok" | "occ_gate" | "baked_only" |
        "unbaked"."""
        if camera is None:
            xf = self.dataset.xforms
            camera = xf[0] if len(xf) else self.camera_matrix
        saved_cam = self.camera_matrix
        self.camera_matrix = np.asarray(camera, np.float32)
        saved_flash = self.flash
        saved_overrides = dict(self.march_overrides)
        sig, feat, sig_log = (self._baked_sigma, self._baked_feat,
                              self._baked_sigma_log)
        try:
            def probe():
                out = self.render(width, height, spp=1, linear=False)
                return out[..., :3].astype(np.float64)

            def db(a, b):
                mse = float(np.mean((a - b) ** 2))
                return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)

            self.unbake()
            self.flash = False
            exact = probe()
            self._baked_feat = feat
            self._baked_sigma_log = sig_log    # before the grid: a raw
            self._baked_sigma = sig            # grid read as sigma is junk
            self.flash = saved_flash
            p = db(probe(), exact)
            if p >= threshold_db:
                return p, "ok"
            if saved_flash:
                self.march_overrides = {**saved_overrides,
                                        "vector_occ_gate": True}
                p_gate = db(probe(), exact)
                if p_gate >= threshold_db:
                    warnings.warn(
                        f"bake fidelity probe: flash bundle scored {p:.1f} "
                        f"dB vs the exact render (< {threshold_db:.0f} dB); "
                        f"re-enabled the per-sample occupancy gate "
                        f"({p_gate:.1f} dB)")
                    saved_overrides = dict(self.march_overrides)
                    return p_gate, "occ_gate"
                self.march_overrides = saved_overrides
                self.flash = saved_flash = False
                p_baked = db(probe(), exact)
                if p_baked >= threshold_db:
                    warnings.warn(
                        f"bake fidelity probe: flash scored {p:.1f} dB vs "
                        f"the exact render; disabled flash (baked sigma + "
                        f"per-sample network color: {p_baked:.1f} dB)")
                    return p_baked, "baked_only"
                p = p_baked
            warnings.warn(
                f"bake fidelity probe: baked render scored {p:.1f} dB vs "
                f"the exact render (< {threshold_db:.0f} dB); unbaked, "
                f"rendering exact")
            self.unbake()
            saved_flash = False
            return p, "unbaked"
        finally:
            self.camera_matrix = saved_cam
            self.flash = saved_flash
            self.march_overrides = saved_overrides
            self.reset_accumulation()

    def set_surface_buffers(self, surface_rgba, t_surface, width, height):
        """Install the mesh pass's per-pixel colour and depth
        (copyRaytracingBuffersToNerfRays, nerf_mesh_renderer.cu:64-100)."""
        self._surface_rgba = surface_rgba
        self._surface_t = t_surface
        self._surface_res = (width, height)

    def reset_accumulation(self, due_to_camera_movement=False,
                           immediate_redraw=True):
        """The reference's signature; both flags steer its GUI redraw and
        change nothing here."""
        self._spp = 0

    def reset(self, reset_density_grid: bool = True):
        """reset_network (python_api.cu:334): a fresh network from seed
        1337; with reset_density_grid an empty grid."""
        gen = torch.Generator(device=self.device).manual_seed(1337)
        self.net = init_params(self.config, gen, self.device)
        self.training_step = 0
        if reset_density_grid and self.density_grid is not None:
            self.density_grid = np.zeros_like(self.density_grid)
            self.update_occupancy()
        self.reset_accumulation()

    @torch.no_grad()
    def render_frame_buffers(self, width: int, height: int,
                             sample_index: int = 0, camera_end=None,
                             rolling_shutter=None):
        """One sample -> (frame (H, W, 4) linear premultiplied, depth
        (H, W)) tensors on the device. camera_end and rolling_shutter (4,)
        give each pixel its own camera (render_with_rolling_shutter)."""
        if self.net is None:
            raise RuntimeError("no snapshot loaded")
        surface_rgba = t_surface = None
        if (self._surface_rgba is not None
                and self._surface_res == (width, height)):
            surface_rgba, t_surface = self._surface_rgba, self._surface_t
        # lens-distorted ray generation (render_nerf's render_lens and
        # distortion-grid gating, testbed.cu:1530-1535)
        lens_mode, lens_params, distortion_grid = "perspective", None, None
        if self.nerf.render_with_lens_distortion:
            if self.dataset.metadata:
                md = self.dataset.metadata[0]
                lens_mode, lens_params = md.lens_mode, md.lens_params
            distortion_grid = self.distortion_map
        opts = self._march_options()
        # the flash coarse init serves plain perspective cameras only; say
        # which path ran
        plain_cam = (lens_mode == "perspective" and distortion_grid is None
                     and camera_end is None and opts.aperture_size == 0.0)
        if opts.use_baked_sigma and opts.lowres_factor > 1:
            if plain_cam:
                self.last_render_path = "flash"
            else:
                self.last_render_path = ("baked (flash disabled: non-plain "
                                         "camera)")
                if not self._warned_flash_fallback:
                    self._warned_flash_fallback = True
                    print("nerf-glasses-tpu: flash coarse init supports "
                          "plain perspective cameras only; this render "
                          "(DoF/lens/shutter/distortion) uses the baked "
                          "march without it", file=sys.stderr)
        elif opts.use_baked_sigma:
            self.last_render_path = "baked"
        else:
            self.last_render_path = "unbaked"
        frame, depth, self.last_march_epochs = raymarch.render_image_device(
            self.net, self._scene(), self.camera_matrix, width, height, opts,
            surface_rgba, t_surface, sample_index,
            linear_colors=self.linear_colors, lens_mode=lens_mode,
            lens_params=lens_params, snap_centers=self.snap_to_pixel_centers,
            camera_end=camera_end, rolling_shutter=rolling_shutter,
            distortion_grid=distortion_grid)
        return frame, depth

    def render(self, width: int = 1920, height: int = 1080, spp: int = 1,
               linear: bool = True) -> np.ndarray:
        """Offscreen render -> (H, W, 4) float numpy (render_to_cpu,
        python_api.cu:83-111): accumulate spp samples, then tonemap
        (sRGB unless linear)."""
        return self._render_spp(width, height, spp, linear)

    def render_with_rolling_shutter(self, camera_transform_start,
                                    camera_transform_end, rolling_shutter,
                                    width: int, height: int, spp: int = 1,
                                    linear: bool = True) -> np.ndarray:
        """render() with a per-pixel shutter time
        (render_with_rolling_shutter_to_cpu, python_api.cu:113-126): the
        cameras arrive in NeRF (dataset) space, and each ray renders
        through start * ray_time + end * (1 - ray_time), ray_time = rs.x
        + rs.y u + rs.z v + rs.w rand (testbed.cu:398-406)."""
        ds = self.dataset
        start, end = (ds_io.nerf_matrix_to_ngp(np.asarray(m), ds.scale,
                                               ds.offset, ds.from_mitsuba)
                      for m in (camera_transform_start, camera_transform_end))
        rshut = np.asarray(rolling_shutter, np.float32).reshape(4)
        saved = self.camera_matrix.copy()
        self.camera_matrix = start
        try:
            return self._render_spp(width, height, spp, linear,
                                    camera_end=end, rolling_shutter=rshut)
        finally:
            self.camera_matrix = saved

    def _render_spp(self, width, height, spp, linear, **ray_kw):
        self.reset_accumulation()
        accum = None
        for i in range(spp):
            frame, depth = self.render_frame_buffers(width, height, i,
                                                     **ray_kw)
            accum = accumulate(torch.zeros_like(frame) if accum is None
                               else accum, frame, i, self.color_space)
        self._depth_buffer = depth
        self._frame_buffer = frame
        out = tonemap_frame(accum, self.exposure, self.background_color,
                            self.color_space, "linear" if linear else "srgb",
                            self.tonemap_curve)
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # Density queries
    # ------------------------------------------------------------------

    @torch.no_grad()
    def density_at(self, positions: np.ndarray) -> np.ndarray:
        """Activated density at NGP-space positions (N, 3) -> (N,) numpy
        (bf16 MLPs, f32 encode, as the JAX package's density_at)."""
        pos = torch.as_tensor(np.asarray(positions, np.float32),
                              device=self.device)
        lo = torch.as_tensor(self.aabb.min, device=self.device)
        extent = torch.as_tensor(self.aabb.diag(), device=self.device)
        raw = self.net.density_raw((pos - lo) / extent)[:, 0]
        return apply_density_activation(
            raw, self.config.density_activation).cpu().numpy()

    @torch.no_grad()
    def collide_distances(self, origins_ngp: np.ndarray,
                          direction: np.ndarray) -> np.ndarray:
        """March points along `direction` to the first density hit
        (NerfTracer::collide, testbed.cu:1814-1888) -> distances (N,)
        numpy, 0 where a point left the aabb without one. The turns the
        march took are kept in last_collide_turns."""
        d = np.asarray(direction, np.float64)
        d = (d / np.linalg.norm(d)).astype(np.float32)
        dist, self.last_collide_turns = raymarch.collide_march(
            self.net, self._scene(),
            torch.as_tensor(np.asarray(origins_ngp, np.float32),
                            device=self.device),
            torch.as_tensor(d, device=self.device), self._march_options())
        return dist.cpu().numpy()

    @torch.no_grad()
    def alpha_at(self, positions: np.ndarray,
                 dt: float = C.MIN_CONE_STEPSIZE) -> np.ndarray:
        """alpha = 1 - exp(-density * dt), 0 outside the occupancy grid
        (NerfTracer::intersects, testbed.cu:1891-1936): positions (N, 3)
        in NGP space -> (N,) numpy, computed on the device, one fetch."""
        pos = torch.as_tensor(np.asarray(positions, np.float32),
                              device=self.device)
        lo = torch.as_tensor(self.aabb.min, device=self.device)
        extent = torch.as_tensor(self.aabb.diag(), device=self.device)
        raw = self.net.density_raw((pos - lo) / extent)[:, 0]
        dens = apply_density_activation(raw, self.config.density_activation)
        alpha = 1.0 - torch.exp(-dens * dt)
        mip = torch.clamp(
            occ_ops.mip_from_dt(torch.full((pos.shape[0],), dt,
                                           device=self.device),
                                pos, self.config.max_cascade), min=0)
        occ = occ_ops.occupied_at(self.occ, pos, mip)
        return torch.where(occ, alpha, 0.0).cpu().numpy()

    # ------------------------------------------------------------------
    # Training: the pyngp surface the reference train.py drives
    # (volume/train.py:17-26: load_training_data, shall_train, frame)
    # ------------------------------------------------------------------

    def load_training_data(self, path: str):
        self.dataset = ds_io.load_transforms_json(path, load_images=True)
        self._trainer = None

    def clear_training_data(self):
        self.dataset.images = None
        self._trainer = None

    def create_empty_nerf_dataset(self, n_images: int, aabb_scale: int = 1,
                                  is_hdr: bool = False):
        self.dataset = ds_io.create_empty_nerf_dataset(n_images, aabb_scale,
                                                       is_hdr)
        self._trainer = None

    def set_training_image(self, frame_idx: int, img: np.ndarray,
                           depth_img=None, depth_scale: float = 1.0):
        """pyngp set_image (python_api.cu:51-69): img (H, W, 4) float32,
        linear, premultiplied alpha, unsharp-masked when nerf.sharpen > 0.
        depth_img is an optional (H, W) depth in dataset units; times
        depth_scale * dataset.scale it is stored in NGP units. Pixels
        with depth <= 0 carry no supervision."""
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError("image should be (H,W,C) where C=4")
        if self.nerf.sharpen > 0.0:
            img = ds_io.sharpen_image(img, float(self.nerf.sharpen))
        self.dataset.images[frame_idx] = img
        self.dataset.metadata[frame_idx].resolution = (img.shape[1],
                                                       img.shape[0])
        if depth_img is not None:
            if self.dataset.depth_images is None:
                self.dataset.depth_images = [None] * self.dataset.n_images
            self.dataset.depth_images[frame_idx] = (
                np.asarray(depth_img, np.float32)
                * float(depth_scale) * float(self.dataset.scale))
        self._trainer = None

    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True):
        m = np.asarray(camera_to_world, np.float32)[:3, :4]
        if convert_to_ngp:
            m = ds_io.nerf_matrix_to_ngp(m, self.dataset.scale,
                                         self.dataset.offset,
                                         self.dataset.from_mitsuba)
        self.dataset.xforms[frame_idx] = m
        if self.dataset.xforms_end is not None:
            self.dataset.xforms_end[frame_idx] = m
        self._trainer = None

    def get_camera_extrinsics(self, frame_idx: int) -> np.ndarray:
        return ds_io.ngp_matrix_to_nerf(self.dataset.xforms[frame_idx],
                                        self.dataset.scale,
                                        self.dataset.offset,
                                        self.dataset.from_mitsuba)

    def _ensure_trainer(self):
        if self._trainer is None:
            from nerf_glasses_tpu_torch.train.trainer import (TrainOptions,
                                                              Trainer)
            cfg = self.config
            if self.dataset.aabb_scale != cfg.aabb_scale:
                cfg = _replace_cfg(cfg, aabb_scale=self.dataset.aabb_scale)
            self._trainer = Trainer(self.dataset, TrainOptions(config=cfg),
                                    device=self.device)
        return self._trainer

    def train(self, n_steps: int = 16) -> float:
        """n_steps of training; the Testbed then renders and saves the
        trainer's live network and grid, in the trainer's training box
        and with its cone angle (an aabb_scale > 1 dataset trains in a
        larger box than a fresh Testbed's unit cube)."""
        tr = self._ensure_trainer()
        self.loss = tr.train(n_steps)
        self.training_step = tr.step
        if self.config.aabb_scale != tr.opts.config.aabb_scale:
            self._cone_angle = tr.opts.config.cone_angle_constant
        self.config = tr.opts.config
        if not (np.array_equal(self.aabb.min, tr.aabb_min)
                and np.array_equal(self.aabb.max, tr.aabb_max)):
            self.aabb = BoundingBox(tr.aabb_min, tr.aabb_max)
            self.render_aabb = self.aabb.copy()
        self.net = tr.net
        self.density_grid = tr.state["density_grid"].cpu().numpy()
        self.occ = tr.state["occ"]
        return self.loss

    def frame(self) -> bool:
        """pyngp-style frame(): one training step when shall_train."""
        if self.shall_train and self.dataset.images is not None:
            self.train(1)
        return True

    def sync_from_trainer(self):
        """Adopt a copy of the trainer's network, its grid and aabbs for
        rendering and saving."""
        tb = self._ensure_trainer().to_testbed()
        self.config = tb.config
        self.net = tb.net
        self.density_grid = tb.density_grid
        self.aabb = tb.aabb
        self.raw_aabb = tb.raw_aabb
        self.render_aabb = tb.render_aabb
        self.render_aabb_to_local = tb.render_aabb_to_local
        self._cone_angle = tb._cone_angle
        self.occ = tb.occ

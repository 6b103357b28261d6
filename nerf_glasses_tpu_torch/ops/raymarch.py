"""Volumetric ray marching with occupancy-grid skipping and depth-gated
mesh-surface compositing: the exact (unbaked) path.

Port of nerf_glasses_tpu/ops/raymarch.py (the reference's NerfTracer:
init_rays_with_payload testbed.cu:355-467, advance_pos_nerf :470-537,
generate_next_nerf_network_inputs :564-633, composite_kernel_nerf
:784-905, trace loop :1938-2053).

`march_frame_impl` runs eagerly: each epoch walks the alive rays
through empty space on occupancy lookups alone, then spends one K-sample
round on them. Every ray's result is independent of how rays are
batched or ordered, so the epoch processes all alive rays as one batch
where the JAX package used fixed 4096-ray chunks; the network runs only
on the round's valid samples (an invalid sample composites with weight 0
in both packages). The exact epoch of sequential rounds (`_march_lists`)
reads and writes the frame's own arrays through the epoch's live-ray
list: one walk (march_cuda.walk_list: the advance, the round's samples,
the network's input rows), the network on the rows, one composite
(march_cuda.composite_list, which lists the rays still alive for the
next epoch), and one host read an epoch. The baked and vector rounds
(`_march_gathered`) gather the alive rays into a compacted copy each
epoch (one host read, `_march_round`) and scatter it back. The per-ray
loops (init_rays' walk, the walks, a round's non-vector composite, which
reads the network's rows where the network left them and applies the
activations itself) are ops/march_cuda.py's: a CUDA kernel each on the
card, their plain versions on the CPU; the network, the compaction of
the gathered route and the vector rounds stay PyTorch.

Mesh-surface gating, as in the reference: rays with a surface are
revived at t_surface (testbed.cu:487-493); an opaque surface stops the
march (:600-607); crossing t_surface blends the surface colour in
front-to-back order (:843-857); rays that end blend any unconsumed
surface colour with the remaining transmittance (:886-897).

Multi-cascade scenes (aabb_scale > 1) probe the occupancy level that
governs each sample (mip_from_dt) and, with `MarchOptions.dist_advance`,
cross empty space on the per-cascade clearance pyramid (`_dist_probe_mips`):
one lookup gives the occupancy bit and a hop to the edge of the empty ball
around the voxel, landed on the cone-stepping ladder (`_ladder_jump`).
Testbed turns it on for every multi-cascade path: the bounded per-voxel
init walk rarely settles there, t_start stays 0, and the march would gate
at coarse absolute-t mips.

The fast path (`MarchOptions.use_baked_sigma`, ops/bake.py) reads sigma
from a baked grid instead of the network (one grid per cascade, sampled
at each sample's mip). Its flash form adds a coarse
init (`flash_init`: occupied voxels splatted into a 1/F-resolution depth
grid, min-filtered), 16-sample vector rounds and one deferred shade per
ray. Where the JAX package coloured whole 4096-sample windows of a stable
partition, so that whether a non-significant sample or ray got colour
depended on chunk sizes, the port has one rule: the significant-colour
pass colours exactly the significant samples, and the deferred shade
shades each ray with wn > 1e-4 exactly once.

The frame's rays (`render_image_device`) follow pixel_to_ray: per-sample
Halton(2, 3) sub-pixel offsets or pinned pixel centres, the lens models
(perspective, OpenCV, f-theta, lat-long), a trained distortion grid, a
rolling shutter's per-pixel camera and a depth-of-field aperture. Only a
plain perspective camera takes the flash coarse init. A model trained
with latent codes reads them from scene["extra_dims"] in every colour
evaluation. The frame around the march is ops/frame_cuda.py's: a plain
camera's rays, init_rays (init_rays_with_payload + advance_pos_nerf), the
state's fills and the first live-ray list are `ray_init` (one kernel on
the card, two around the init walk where it has probes; any other
camera's rays are made here, `_lens_rays`, and handed to it, as are the
given rays of march_rays and march_frame_impl), and the finish is
`finalize`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as nnf

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops import frame_cuda, march_cuda, network_cuda
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops.bake import (sample_baked_sigma,
                                             sample_baked_sigma_mip,
                                             sample_feat_grid,
                                             sample_feat_grid_mip)
from nerf_glasses_tpu_torch.ops.compaction import stable_partition_ids
# the ray init and the frame's finish live with their kernels
from nerf_glasses_tpu_torch.ops.frame_cuda import (  # noqa: F401
    finalize_state as _finalize, hash_u32 as _hash_u32, init_rays,
    make_state as _make_state, upsample_flash_init)
from nerf_glasses_tpu_torch.ops.hashgrid import U32, mul_u32
# the empty-space probes live beside the march kernels that carry them
from nerf_glasses_tpu_torch.ops.march_cuda import (  # noqa: F401
    _contains_local, _dist_probe, _dist_probe_mips, _ladder_jump, _occupied,
    _ray_exit_t, _skip_probe)
from nerf_glasses_tpu_torch.ops.network import (NerfNetwork,
                                                apply_density_activation,
                                                apply_rgb_activation)
from nerf_glasses_tpu_torch.utils.bbox import contains_aabb, ray_intersect_aabb


@dataclasses.dataclass(frozen=True)
class MarchOptions:
    config: NGPConfig
    cone_angle: float = 0.0
    min_transmittance: float = C.DEFAULT_MIN_TRANSMITTANCE
    steps_per_round: int = C.MAX_STEPS_INBETWEEN_COMPACTION   # K
    skip_iters: int = 3          # DDA skips per sample slot in a round
    init_skip_iters: int = 16    # bounded DDA skips at ray init
    advance_iters: int = 48      # per-epoch empty-space advance
    max_rounds: int = C.MARCH_ITER // C.MAX_STEPS_INBETWEEN_COMPACTION
    min_mip: int = 0             # floor of every occupancy probe's level
    rounds_per_epoch: int = 1    # K-sample rounds between compactions
    jitter: bool = True
    compute_dtype: str = "bfloat16"
    # Batch sizes of the JAX package's compacted chunks, colour windows
    # and shade windows. The port processes each epoch, colour pass and
    # shade as one batch and does not read them; they are fields so that
    # the JAX option bundles pass through unchanged.
    chunk: int = 1 << 12
    color_subchunk: int = 1 << 12
    shade_chunk: int = None
    # Baked fast path (ops/bake.py): sigma from scene["sigma"]; the colour
    # pass runs only on samples whose prospective weight exceeds
    # sig_threshold.
    use_baked_sigma: bool = False
    baked_sigma_log: bool = False   # grid holds raw density: activate
                                    # after the trilinear lookup
    sig_threshold: float = 1e-3
    # A round's K samples at t + i*dt in one shot, composited in closed
    # form; unoccupied samples get zero alpha instead of being skipped.
    vector_rounds: bool = False
    # No colour in the march: one colour evaluation per ray at its
    # max-weight sample, scaled by its NeRF weight wn (_deferred_shade).
    deferred_color: bool = False
    # Significant-sample colour from scene["feat"] + the rgb MLP instead
    # of the full network (ignored under deferred_color).
    feat_color: bool = False
    # Flash coarse init (flash_init): 0 = off, else the coarse factor F.
    lowres_factor: int = 0
    lowres_iters: int = 64
    lowres_slack: float = 6.0 / 128.0
    lowres_cull: bool = False       # ray-walk init only: cull rays whose
                                    # 3x3 coarse neighbourhood saw nothing
    lowres_splat_radius: int = 3    # voxel-splat init: min-filter radius
    # Occupancy-gate the vector rounds' samples even with a baked grid.
    vector_occ_gate: bool = True
    # Advance on a distance-to-occupied grid instead of the jump grid or
    # the per-voxel DDA: scene["dist"] (single cascade, constant dt only)
    # or scene["dist_mips"] (multi-cascade), occupancy.build_dist_grid*.
    dist_advance: bool = False
    # Depth of field (pixel_to_ray's aperture, ngp_common.cuh:330-345):
    # origins jittered on a Shirley disk of radius aperture_size in the
    # camera plane, each ray re-aimed at its point on the focus_z plane.
    aperture_size: float = 0.0
    focus_z: float = 1.0

    @property
    def cdtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32


def make_scene(occ_grid, render_aabb_min, render_aabb_max,
               render_aabb_to_local, train_aabb_min, train_aabb_max,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Bundle the non-parameter scene tensors."""
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    if not torch.is_tensor(occ_grid):
        occ_grid = torch.from_numpy(np.array(occ_grid, np.uint8))
    occ = occ_grid.to(device=device, dtype=torch.uint8)
    return {
        "occ": occ,
        "skip": occ_ops.build_skip_grid(occ),   # cascade-0 jump levels
        "render_min": f(render_aabb_min),
        "render_max": f(render_aabb_max),
        "local": f(render_aabb_to_local),
        "train_min": f(train_aabb_min),
        "train_max": f(train_aabb_max),
    }


def scene_with_extra_dims(scene: Dict, extra_dims) -> Dict:
    """The scene with inference latent codes (E,) for a model trained with
    n_extra_learnable_dims > 0 (testbed.cu:1614-1631)."""
    return {**scene, "extra_dims": torch.as_tensor(
        np.asarray(extra_dims, np.float32), device=scene["occ"].device)}


def _radical_inverse(base: int, i: int) -> float:
    """Halton radical inverse -> [0, 1); the per-sample sub-pixel offset."""
    i = int(i)
    f = 1.0 / base
    out = 0.0
    while i > 0:
        out += f * (i % base)
        i //= base
        f /= base
    return out


# ---------------------------------------------------------------------------
# Lens models (utils/lens.py's numpy versions as tensor ops; the reference's
# pixel_to_ray, ngp_common.cuh:277-372)
# ---------------------------------------------------------------------------

def _f_theta_dirs(uv, lens_params):
    """uv (..., 2) offsets from the screen centre -> camera-space dirs
    (f_theta_undistortion, ngp_common.cuh:277-291); a ray with no stable
    solution gets dir (1000, 0, 0), which puts it outside the aabb."""
    p = lens_params
    xpix = uv[..., 0] * p[5]
    ypix = uv[..., 1] * p[6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = p[0] + norm * (p[1] + norm * (p[2] + norm * (p[3] + norm * p[4])))
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    bad = (cos_a <= float(np.finfo(np.float32).tiny)) | (norm == 0.0)
    s = sin_a / torch.where(norm == 0.0, 1.0, norm)
    out = torch.stack([s * xpix, s * ypix, cos_a], dim=-1)
    err = torch.tensor([1000.0, 0.0, 0.0], device=uv.device)
    return torch.where(bad[..., None], err, out)


def _latlong_dirs(uv):
    """uv (..., 2) in [0, 1] -> unit dirs (latlong_to_dir,
    ngp_common.cuh:293-299)."""
    theta = (uv[..., 1] - 0.5) * np.pi
    phi = (uv[..., 0] - 0.5) * np.pi * 2.0
    ct = torch.cos(theta)
    return torch.stack([torch.sin(phi) * ct, torch.sin(theta),
                        torch.cos(phi) * ct], dim=-1)


def _opencv_undistort(x, y, lens_params, iterations: int = 10):
    """Invert the OpenCV radial + tangential distortion by fixed-point
    iteration (upstream's iterative_opencv_lens_undistortion)."""
    k1, k2, p1, p2 = (lens_params[0], lens_params[1], lens_params[2],
                      lens_params[3])
    xu, yu = x, y
    for _ in range(iterations):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu, yu = (x - dx) / radial, (y - dy) / radial
    return xu, yu


def _read_image2(grid, uv):
    """Bilinear (pos * (res - 1)) sample of an (Hg, Wg, 2) grid at uv
    (..., 2), read_image<2> semantics (ngp_common.cuh:302-332): the
    trained distortion map."""
    hg, wg = grid.shape[0], grid.shape[1]
    pf = torch.stack([uv[..., 0] * (wg - 1), uv[..., 1] * (hg - 1)], -1)
    t = torch.floor(pf)
    w = pf - t
    ti = t.long()
    flat = grid.reshape(hg * wg, -1)

    def at(dx, dy):
        xi = torch.clamp(ti[..., 0] + dx, 0, wg - 1)
        yi = torch.clamp(ti[..., 1] + dy, 0, hg - 1)
        return flat[yi * wg + xi]

    return ((1 - w[..., :1]) * (1 - w[..., 1:]) * at(0, 0)
            + w[..., :1] * (1 - w[..., 1:]) * at(1, 0)
            + (1 - w[..., :1]) * w[..., 1:] * at(0, 1)
            + w[..., :1] * w[..., 1:] * at(1, 1))


# ---------------------------------------------------------------------------
# Flash coarse init: a conservative first-hit floor per FxF pixel block
# ---------------------------------------------------------------------------

def lowres_t_enter(scene, o, d, opts: MarchOptions):
    """Walk rays to the first occupied voxel on occupancy lookups alone
    -> (t (N,), hit (N,) bool); rays that neither hit nor exit within
    lowres_iters report their current t with hit=True (conservative)."""
    tmin, _ = ray_intersect_aabb(o, d, scene["render_min"],
                                 scene["render_max"])
    t = torch.clamp(tmin, min=0.0) + 1e-6
    alive = contains_aabb(o + d * t[:, None], scene["render_min"],
                          scene["render_max"])
    idir = 1.0 / d
    settled = ~alive
    for _ in range(opts.lowres_iters):
        pos = o + d * t[:, None]
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        newly_exit = ~settled & alive & ~inside
        newly_hit = ~settled & alive & inside & occ
        alive = alive & ~newly_exit
        settled = settled | newly_hit | ~alive
        t = torch.where(~settled & alive, adv, t)
    return t, alive


def _min_filter(img: torch.Tensor, radius: int, pad_mode: str):
    """(H, W) -> min over the (2r+1)^2 neighbourhood; "inf" pads with
    +inf (max_pool2d's implicit pad), "edge" replicates the border."""
    k = 2 * radius + 1
    x = -img[None, None]
    if pad_mode == "edge":
        x = nnf.pad(x, (radius,) * 4, mode="replicate")
        return -nnf.max_pool2d(x, k, stride=1)[0, 0]
    return -nnf.max_pool2d(x, k, stride=1, padding=radius)[0, 0]


def flash_init(scene, cam: torch.Tensor, width: int, height: int,
               opts: MarchOptions):
    """Flash coarse init -> (t_floor (H/F, W/F), alive (H/F, W/F) bool)
    for a plain perspective packed camera (3, 4).

    - Voxel splat (scene["occ_pts"], the (M, 3) centres of the occupied
      voxels of every cascade, in raw coordinates): project every
      occupied voxel, scatter-min its camera depth, less its pad
      scene["occ_pts_pad"] where the scene has one (the voxel's half
      diagonal: a coarse cascade's voxel reaches further toward the eye
      than lowres_slack covers), into the coarse grid (an inf-filled
      grid with one overflow slot for points off screen or behind the
      eye), min-filter with radius lowres_splat_radius over +inf padding.
      Every occupied voxel lands in the grid, so the cull is
      conservative.
    - Ray walk (no occ_pts): one occupancy walk per FxF block
      (lowres_t_enter), 3x3 min filter over edge padding; rays are culled
      only with lowres_cull.
    Floors are the filtered first-hit distances minus lowres_slack."""
    F = opts.lowres_factor
    Hl = (height + F - 1) // F
    Wl = (width + F - 1) // F
    if "occ_pts" in scene:
        pts = scene["occ_pts"]
        eye = cam[:, 3] + 0.5
        q = (pts - eye) @ torch.linalg.inv(cam[:, :3]).T  # (x*s, y*s, s)
        qz = q[:, 2]
        valid = qz > 1e-6
        qs = torch.where(valid, qz, 1.0)
        u = q[:, 0] / qs * 0.5 + 0.5
        v = q[:, 1] / qs * 0.5 + 0.5
        cx = torch.floor(u * width / F).long()
        cy = torch.floor(v * height / F).long()
        inb = valid & (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
        cell = torch.where(inb, cy * Wl + cx, Hl * Wl)
        tgrid = torch.full((Hl * Wl + 1,), torch.inf, device=pts.device)
        if "occ_pts_pad" in scene:
            qz = qz - scene["occ_pts_pad"]
        tgrid = tgrid.scatter_reduce(0, cell, qz, "amin")
        tmin = _min_filter(tgrid[:-1].reshape(Hl, Wl),
                           opts.lowres_splat_radius, "inf")
        alive_img = torch.isfinite(tmin)
        return torch.where(alive_img, tmin - opts.lowres_slack, 0.0), alive_img

    f32 = dict(dtype=torch.float32, device=cam.device)
    lx = torch.arange(Wl, **f32)[None].expand(Hl, Wl)
    ly = torch.arange(Hl, **f32)[:, None].expand(Hl, Wl)
    ul = (lx * F + 0.5 * F) / width * 2.0 - 1.0
    vl = (ly * F + 0.5 * F) / height * 2.0 - 1.0
    ndc = torch.stack([ul, vl, torch.ones((Hl, Wl), **f32)], -1).reshape(-1, 3)
    ld = ndc @ cam[:, :3].T
    ld = ld / torch.linalg.vector_norm(ld, dim=-1, keepdim=True)
    lo = (cam[:, 3] + 0.5).expand(ld.shape)
    t_l, hit_l = lowres_t_enter(scene, lo, ld, opts)
    tmin = _min_filter(torch.where(hit_l, t_l, torch.inf).reshape(Hl, Wl),
                       1, "edge")
    alive_img = torch.isfinite(tmin)
    tmin = torch.where(alive_img, tmin - opts.lowres_slack, 0.0)
    if not opts.lowres_cull:
        # safe mode: un-hit rays start at the aabb entry instead of dying
        alive_img = torch.ones_like(alive_img)
    return tmin, alive_img


# ---------------------------------------------------------------------------
# Advance pass: move rays through empty space to the next occupied voxel
# without network rounds. Rays exiting the aabb with no pending surface
# die; rays with a pending surface are parked at t_surface.
# ---------------------------------------------------------------------------

def _advance_pass(st, scene, opts: MarchOptions, iters: int):
    t, alive = march_cuda.advance(st, scene, opts, iters)
    return {**st, "t": t, "alive": alive}


# ---------------------------------------------------------------------------
# One K-sample round on a ray-state dict
# ---------------------------------------------------------------------------

def _vector_samples(st, scene, opts: MarchOptions):
    """All K samples of a round at t + i*dt in one shot; same outputs as
    march_cuda.samples. With cone stepping dt is per ray, constant
    within the round (slight oversampling)."""
    K = opts.steps_per_round
    o, d = st["o"], st["d"]
    n = o.shape[0]
    t, alive, t_surface = st["t"], st["alive"], st["t_surf"]
    if opts.cone_angle == 0.0:
        dt_r = torch.full((n,), C.MIN_CONE_STEPSIZE, device=o.device)
    else:
        dt_r = occ_ops.calc_dt(t - st["t_start"], opts.cone_angle)
    t_i = t[None] + dt_r[None] * torch.arange(
        K, dtype=torch.float32, device=o.device)[:, None]     # (K, n)
    pos_k = o[None] + d[None] * t_i[..., None]                 # (K, n, 3)
    surf_block = ((t_surface > 0.0)[None] & (t_i > t_surface[None])
                  & (st["surf_a"][None] >= 1.0))
    inside = t_i <= _ray_exit_t(o, d, scene)[None]
    dt_k = dt_r[None].expand(K, n)
    valid = inside & ~surf_block
    if not opts.use_baked_sigma or opts.vector_occ_gate:
        occ_k, _ = _occupied(scene, pos_k.reshape(-1, 3), dt_k.reshape(-1),
                             opts)
        valid = valid & occ_k.reshape(K, n)
    surf_stopped = surf_block.any(dim=0) & alive
    exited = (~inside).any(dim=0) & alive & ~surf_stopped
    t_end = torch.where(alive, torch.where(surf_stopped, t_surface,
                                           t + K * dt_r), t)
    return (pos_k, dt_k, valid, t_i), t_end, exited, surf_stopped


def _exclusive_cumprod(x):
    """(K, n) -> prod_{j<i} x_j along dim 0."""
    return torch.cat([torch.ones_like(x[:1]), torch.cumprod(x, 0)[:-1]], 0)


def _march_round(st, net: NerfNetwork, scene, opts: MarchOptions,
                 generated=None):
    """Generate up to K samples per ray, colour them, composite
    (composite_kernel_nerf semantics); returns the updated state.
    generated: the round's samples where they were made already
    (march_cuda.advance_samples' second half), else None."""
    cfg = opts.config
    K = opts.steps_per_round
    d = st["d"]
    n = d.shape[0]
    surface_rgba = st["surf"]
    alive = st["alive"]

    if generated is None:
        gen = _vector_samples if opts.vector_rounds else march_cuda.samples
        generated = gen(st, scene, opts)
    (pos, dt_k, valid, ts), t_end, exited, surf_stopped = generated
    # the sequential walk's samples are valid on live rays only already;
    # the vector rounds' are masked here
    if opts.vector_rounds:
        valid = valid & alive[None]
    rnd = {"t_end": t_end, "exited": exited, "surf_stopped": surf_stopped,
           "valid": valid, "ts": ts}

    # --- in-march surface blend, once before the round's samples, for
    # rays whose payload-t has crossed t_surface (testbed.cu:843-857). It
    # comes first where the colour selection (baked sigma) or the
    # closed-form composite reads the blended state; else it is the first
    # stage of the round's one composite call.
    blend_first = opts.vector_rounds or opts.use_baked_sigma
    if blend_first:
        blended = march_cuda.composite(st, rnd, opts, march_cuda.STAGE_BLEND)
        rgba, wn = blended["rgba"], blended["wn"]
        surf_a, comp_alive = blended["surf_a"], blended["alive"]

    # --- the network's rows: colour (and, unbaked, density) of the
    # samples that need it, in slot order ---------------------------------
    pos01 = (pos - scene["train_min"]) / (scene["train_max"]
                                          - scene["train_min"])
    dir01 = ((d + 1.0) * 0.5)[None].expand(K, n, 3)
    multi = cfg.max_cascade > 0
    if opts.use_baked_sigma:
        if multi:
            # one grid per cascade: the sample's mip is the occupancy
            # gate's (testbed.cu:188-202)
            mip_k = occ_ops.mip_from_dt(dt_k, pos, cfg.max_cascade)
            sigma = sample_baked_sigma_mip(scene["sigma"], pos, mip_k)
        else:
            sigma = sample_baked_sigma(scene["sigma"], pos01)
        if opts.baked_sigma_log:
            sigma = apply_density_activation(sigma, cfg.density_activation)
        alpha_k = torch.where(valid, 1.0 - torch.exp(-sigma * dt_k), 0.0)
        # colour only the samples whose prospective weight is significant
        T0 = torch.where(comp_alive, 1.0 - rgba[:, 3], 0.0)
        w_prosp = alpha_k * T0[None] * _exclusive_cumprod(1.0 - alpha_k)
        color = valid & (w_prosp > opts.sig_threshold)
        if opts.deferred_color:
            color = torch.zeros_like(color)   # coloured once per ray later
        rnd.update(alpha=alpha_k, color=color)
    else:
        color = valid
        rnd["dt"] = dt_k
    sel = torch.nonzero(color.reshape(-1)).squeeze(1)
    rnd["slots"] = sel
    rgb_raw, sigma_raw = d.new_empty((0, 3)), d.new_empty((0,))
    if sel.numel():
        p, dr = pos01.reshape(-1, 3)[sel], dir01.reshape(-1, 3)[sel]
        if opts.use_baked_sigma and opts.feat_color and "feat" in scene:
            if multi:
                feat = sample_feat_grid_mip(
                    scene["feat"], cfg.max_cascade + 1,
                    pos.reshape(-1, 3)[sel], mip_k.reshape(-1)[sel])
            else:
                feat = sample_feat_grid(scene["feat"], p)
            rgb_raw = net.rgb_from_features(feat, dr,
                                            compute_dtype=opts.cdtype,
                                            extra=scene.get("extra_dims"))
        else:
            rgb_raw, sigma_raw = net(p, dr, compute_dtype=opts.cdtype,
                                     extra=scene.get("extra_dims"))
    rnd["rgb"] = rgb_raw
    if not opts.use_baked_sigma:
        rnd["sigma"] = sigma_raw

    if not opts.vector_rounds:
        # front-to-back over the K samples, then the final surface blend;
        # the kernel reads the rows where the network left them
        if blend_first:
            out = march_cuda.composite({**st, **blended}, rnd, opts,
                                       march_cuda.STAGE_SAMPLES)
        else:
            out = march_cuda.composite(st, rnd, opts)
        return {**st, "t": t_end, **out}

    alpha_k, rgb_s = march_cuda.dense_round(rnd, opts)
    # closed-form front-to-back compositing of the round's K samples:
    # w_i = alpha_i T0 prod_{j<i}(1 - alpha_j); samples after the first
    # one that pushes alpha past 1 - min_transmittance are blocked
    depth, max_w = st["depth"], st["max_weight"]
    use = comp_alive[None] & valid
    alpha_u = torch.where(use, alpha_k, 0.0)
    w_all = (alpha_u * (1.0 - rgba[:, 3])[None]
             * _exclusive_cumprod(1.0 - alpha_u))
    a_cum = rgba[:, 3][None] + torch.cumsum(w_all, 0)
    done_k = use & (a_cum > 1.0 - opts.min_transmittance)
    blocked = torch.cat([torch.zeros_like(done_k[:1]),
                         torch.cumsum(done_k, 0)[:-1] > 0], 0)
    w = torch.where(blocked, 0.0, w_all)
    w_sum = torch.sum(w, dim=0)
    rgba = rgba + torch.cat([torch.sum(w[..., None] * rgb_s, dim=0),
                             w_sum[:, None]], dim=-1)
    if opts.deferred_color:
        wn = wn + w_sum
    # depth of the round's max-weight sample (first occurrence) if it
    # beats the carried maximum
    w_max = torch.amax(w, dim=0)
    t_at = torch.gather(ts, 0, torch.argmax(w, dim=0)[None])[0]
    upd = w_max > max_w
    max_w = torch.where(upd, w_max, max_w)
    depth = torch.where(upd, t_at, depth)
    saturated = (done_k & ~blocked).any(dim=0)
    inv = torch.where(saturated, 1.0 / torch.clamp(rgba[:, 3], min=1e-9),
                      1.0)
    rgba = rgba * inv[:, None]
    if opts.deferred_color:
        wn = wn * inv
    comp_alive = comp_alive & ~saturated

    # final surface blend for rays that ended (testbed.cu:886-897)
    terminated_early = exited | surf_stopped
    fin = comp_alive & terminated_early & (surf_a > 0.0)
    rgba = torch.where(fin[:, None],
                       rgba + surface_rgba * (1.0 - rgba[:, 3:4]), rgba)
    comp_alive = comp_alive & ~terminated_early
    return {**st, "t": t_end, "rgba": rgba, "wn": wn, "depth": depth,
            "max_weight": max_w, "alive": comp_alive, "surf_a": surf_a}


def _deferred_shade(st, net: NerfNetwork, scene, opts: MarchOptions):
    """One colour evaluation per ray with wn > 1e-4, at its max-weight
    sample, scaled by its NeRF weight wn and added to its colour. With a
    baked feature grid (scene["feat"]) the colour is one trilinear
    feature lookup + the rgb MLP: no hash-table traffic at all. On
    several cascades the feature pyramid is read at the mip the march's
    gate takes at the shade point's absolute t."""
    cfg = opts.config
    wn = st["wn"]
    ids = torch.nonzero(wn > 1e-4).squeeze(1)
    if ids.numel() == 0:
        return st
    o, d, t = st["o"][ids], st["d"][ids], st["depth"][ids]
    pos_raw = o + d * t[:, None]
    pos01 = torch.clamp((pos_raw - scene["train_min"])
                        / (scene["train_max"] - scene["train_min"]), 0.0, 1.0)
    dir01 = (d + 1.0) * 0.5
    if "feat" in scene:
        if cfg.max_cascade > 0:
            mip = occ_ops.mip_from_dt(occ_ops.calc_dt(t, opts.cone_angle),
                                      pos_raw, cfg.max_cascade)
            feat = sample_feat_grid_mip(scene["feat"], cfg.max_cascade + 1,
                                        pos_raw, mip)
        else:
            feat = sample_feat_grid(scene["feat"], pos01)
        rgb_raw = net.rgb_from_features(feat, dir01,
                                        compute_dtype=opts.cdtype,
                                        extra=scene.get("extra_dims"))
    else:
        rgb_raw, _ = net(pos01, dir01, compute_dtype=opts.cdtype,
                         extra=scene.get("extra_dims"))
    rgb = apply_rgb_activation(rgb_raw, cfg.rgb_activation)
    rgba = st["rgba"].clone()
    rgba[ids, :3] = rgba[ids, :3] + rgb * wn[ids][:, None]
    return {**st, "rgba": rgba}


@torch.no_grad()
def march_rays(net: NerfNetwork, scene, o, d, surface_rgba, t_surface,
               opts: MarchOptions, sample_index=0):
    """March a batch of rays to completion without compaction -> {"rgba"
    (N, 4), "depth" (N,)}: _march_round on all N rays while any is alive
    and fewer than opts.max_rounds rounds ran, then the deferred shade
    when baked and deferred (the JAX package's tile API,
    raymarch.py:1112). Any N; no advance pass and no init skip. The loop
    reads alive.any() from the device once a round."""
    st, _ = _rays_state(scene, o, d, surface_rgba, t_surface, opts,
                        sample_index)
    rounds = 0
    while rounds < opts.max_rounds and bool(st["alive"].any()):
        st = _march_round(st, net, scene, opts)
        rounds += 1
    if opts.deferred_color and opts.use_baked_sigma:
        st = _deferred_shade(st, net, scene, opts)
    return _rays_finish(st, True)


@torch.no_grad()
def march_frame(net: NerfNetwork, scene, o, d, surface_rgba, t_surface,
                opts: MarchOptions, sample_index=0):
    """The compacting march (march_frame_impl) on N rays -> {"rgba" (N, 4),
    "depth" (N,)}. N must be a multiple of opts.chunk, as the JAX
    package requires (raymarch.py:1142)."""
    n = o.shape[0]
    if n % opts.chunk:
        raise ValueError(f"march_frame: {n} rays is not a multiple of "
                         f"chunk {opts.chunk}")
    return march_frame_impl(net, scene, o, d, surface_rgba, t_surface, opts,
                            sample_index)[0]


_GATHER = ("o", "d", "surf", "t_surf", "t_start", "t", "rgba", "depth",
           "max_weight", "surf_a", "wn")
_SCATTER = ("t", "rgba", "depth", "max_weight", "alive", "surf_a", "wn")


def _rays_state(scene, o, d, surface_rgba, t_surface, opts: MarchOptions,
                sample_index=0, t_floor=None, alive_mask=None,
                make_list=False, out=None):
    """The march's state of N given rays (frame_cuda.ray_init on a row of
    N, into `out` where given) -> (state, first)."""
    n = o.shape[0]
    coarse = None
    if t_floor is not None:
        coarse = (t_floor.reshape(1, n), alive_mask.reshape(1, n))
    return frame_cuda.ray_init(scene, opts, None, n, 1, (0.5, 0.5),
                               sample_index, surface_rgba, t_surface, coarse,
                               make_list, rays=(o, d), coarse_factor=1,
                               out=out)


def _rays_finish(st, linear_colors: bool):
    """The march's (N,) state -> {"rgba" (N, 4), "depth" (N,)}
    (frame_cuda.finalize on a row of N)."""
    n = st["t"].shape[0]
    rgba, depth = frame_cuda.finalize(st["rgba"], st["depth"], n, 1,
                                      linear_colors)
    return {"rgba": rgba.reshape(n, 4), "depth": depth.reshape(n)}


def march_frame_impl(net: NerfNetwork, scene, o, d, surface_rgba, t_surface,
                     opts: MarchOptions, sample_index=0, t_floor=None,
                     alive_mask=None, linear_colors=True):
    """March a whole frame -> ({"rgba" (N, 4), "depth" (N,)}, epochs).

    With constant dt on a single cascade the init DDA is skipped: the
    per-epoch advance pass performs the identical quantized stepping (and
    the results depend on this choice, as in the reference package).
    Each epoch is one advance pass and rounds_per_epoch rounds; the epoch
    budget is max_rounds // rounds_per_epoch. Unbaked sequential rounds
    take _march_lists, baked or vector rounds _march_gathered: the two
    give the same frame where both apply. t_floor / alive_mask (N,): the
    flash coarse init (flash_init). The deferred shade runs once at the
    end when the options ask for it. The colour is converted sRGB ->
    linear unless linear_colors (the default keeps the march's own)."""
    opts = frame_options(opts)
    st, first = _rays_state(scene, o, d, surface_rgba, t_surface, opts,
                            sample_index, t_floor, alive_mask,
                            list_route(opts),
                            _frame_out(net, scene, opts, o.shape[0]))
    st, epochs = march_state(net, scene, st, opts, first)
    return _rays_finish(st, linear_colors), epochs


def frame_options(opts: MarchOptions) -> MarchOptions:
    """A frame's options: no init walk with constant dt on a single
    cascade (march_frame_impl)."""
    if opts.cone_angle == 0.0 and opts.config.max_cascade == 0:
        return dataclasses.replace(opts, init_skip_iters=0)
    return opts


def list_route(opts: MarchOptions) -> bool:
    """Whether a frame's epochs take _march_lists (unbaked sequential
    rounds) rather than _march_gathered."""
    return not (opts.vector_rounds or opts.use_baked_sigma)


def march_state(net: NerfNetwork, scene, st, opts: MarchOptions, first=None):
    """The epochs of a frame from its initial state (frame_options'
    options), then the deferred shade where the options ask for it ->
    (state, epochs). first: the list route's first live-ray list
    (frame_cuda.ray_init's), or None."""
    if list_route(opts):
        epochs = _march_lists(net, scene, st, opts, first)
    else:
        epochs = _march_gathered(net, scene, st, opts)
    if opts.deferred_color and opts.use_baked_sigma:
        st = _deferred_shade(st, net, scene, opts)
    return st, epochs


def _epoch_budget(opts: MarchOptions) -> int:
    return max(1, opts.max_rounds // opts.rounds_per_epoch)


def _march_gathered(net: NerfNetwork, scene, st, opts: MarchOptions) -> int:
    """The epochs on a compacted copy of the alive rays, made each epoch
    (stable_partition_ids: one host read) and scattered back into st ->
    epochs. With sequential rounds the advance and the first round's
    samples are one kernel launch (march_cuda.advance_samples)."""
    epochs = 0
    device = st["t"].device
    while epochs < _epoch_budget(opts):
        perm, n_alive = stable_partition_ids(st["alive"])
        if n_alive == 0:
            break
        ids = perm[:n_alive]
        sub = {k: st[k][ids] for k in _GATHER}
        sub["alive"] = torch.ones(n_alive, dtype=torch.bool, device=device)
        generated = None
        if opts.vector_rounds:
            sub = _advance_pass(sub, scene, opts, opts.advance_iters)
        else:
            (t, alive), generated = march_cuda.advance_samples(
                sub, scene, opts, opts.advance_iters)
            sub = {**sub, "t": t, "alive": alive}
        for _ in range(opts.rounds_per_epoch):
            sub = _march_round(sub, net, scene, opts, generated)
            generated = None
        for k in _SCATTER:
            st[k][ids] = sub[k]
        epochs += 1
    return epochs


# The list route runs its epochs in blocks of BLOCK_EPOCHS: the host reads
# the live list's length once a block (with the lengths that entered the
# block's epochs, in the same copy), and on the card a block is one
# replay of a CUDA graph. Where the list empties inside a block, its later
# epochs find it empty and leave the state as it is. The exact 720p frame
# runs 13 epochs and the multi-cascade one 16-17 (PERF.md section 6): 5
# and 5-6 host reads at 4, at the cost of at most 3 empty epochs.
# Even: a block then hands its next list back in the list it started from,
# so one graph serves every block.
BLOCK_EPOCHS = 4
# list marches (buffers and graphs) cached at once, the least recent
# dropped first
LIST_MARCHES = 4
# a first list takes rows for itself and a quarter more, so that a frame
# whose list grows a little keeps its graphs
LIST_MARGIN = 4

_LIST_ARRAYS = ("o", "d", "surf", "t_surf", "t_start", "t", "rgba", "depth",
                "max_weight", "alive", "surf_a", "wn")
_LIST_OUT = ("t", "rgba", "depth", "max_weight", "alive", "surf_a", "wn")
# the graphs' totals since import: captures, replays, and the operations
# (graph nodes) and kernel launches (kernel nodes) the replays put on the
# device
graph_counts = {"captures": 0, "replays": 0, "nodes": 0, "kernels": 0}


@dataclasses.dataclass
class BlockGraph:
    """A captured CUDA graph (capture_graph): its nodes, kernel nodes among
    them, and the wrappers' launches it holds ({module name: {wrapper:
    n}}), added to `modules`' counts at each replay."""
    graph: object
    nodes: int
    kernels: int
    launches: dict
    modules: tuple = ()

    def replay(self):
        """One replay on the current stream, its launches counted (the
        wrappers' counts; graph_counts, which chip_smoke's op_counts
        reads)."""
        self.graph.replay()
        for m in self.modules:
            for k, v in self.launches.get(_short(m), {}).items():
                m.launches[k] += v
        graph_counts["replays"] += 1
        graph_counts["nodes"] += self.nodes
        graph_counts["kernels"] += self.kernels


def _short(module) -> str:
    return module.__name__.rsplit(".", 1)[-1]


def capture_graph(fn, stream, modules, what: str):
    """fn() captured as a CUDA graph on `stream`, a side stream that waits
    for the current one's work, as torch.cuda.graph captures, without its
    synchronize and its emptying of the allocator's caches (work after a
    capture then allocates from them as before), in the thread-local mode
    (another thread's work on the card is not refused) -> (BlockGraph,
    fn's result, whose tensors each replay writes). It runs nothing: the
    launch counts of `modules`' wrappers are put back. A capture that
    fails raises."""
    before = {m: dict(m.launches) for m in modules}
    g = torch.cuda.CUDAGraph(keep_graph=True)
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    try:
        with torch.cuda.stream(stream):
            g.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                g.capture_end()
    except Exception as err:
        raise RuntimeError(f"{what} did not capture as a CUDA graph: "
                           f"{err}") from err
    finally:
        main.wait_stream(stream)
        grew = {_short(m): {k: v - before[m][k] for k, v in m.launches.items()
                            if v != before[m][k]} for m in modules}
        for m in modules:
            m.launches.update(before[m])
    nodes, kernels = march_cuda.graph_nodes(g.raw_cuda_graph())
    g.instantiate()
    graph_counts["captures"] += 1
    return BlockGraph(g, nodes, kernels, grew, tuple(modules)), out


class ListMarch:
    """The list route's march of frames of n rays: the frame's state and
    first list (frame_cuda.state_buffers: ray_init writes a frame into
    them), the spare list, the counters (`ctl`: the list lengths that
    enter a block's epochs, slot 0 the block's first and, after it, the
    next block's; then each round's row count), a round's rows for a first
    list of up to `cap` rays and the network's outputs on them, and on the
    card the graphs of its blocks by their epoch count. The addresses stay
    while it lives, as the graphs need; `state` may be a caller's own
    arrays (the CPU)."""

    def __init__(self, n: int, rounds: int, device, block: int, state=None):
        self.block, self.rounds = block, rounds
        self.ctl = torch.zeros(block + 1 + block * rounds, dtype=torch.int32,
                               device=device)
        self.zeros = torch.zeros_like(self.ctl[1:])
        self.state = state or frame_cuda.state_buffers(n, device)
        self.state["n_ids"] = self.ctl[:1]
        self.spare = torch.empty(n, dtype=torch.int32, device=device)
        self.host = torch.empty(block, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.cap = 0
        self.rows = self.net_out = None
        self.graphs = {}

    def reserve(self, net, opts, n: int, margin: bool):
        """Rows for a first list of n rays: kept where they hold it, else
        made anew (with LIST_MARGIN's room where `margin`), the graphs that
        read the former ones dropped."""
        if n <= self.cap:
            return
        dev = self.ctl.device
        self.rows = self.net_out = None
        self.graphs.clear()
        self.cap = min(self.spare.shape[0],
                       n + n // LIST_MARGIN if margin else n)
        K = opts.steps_per_round
        self.rows = march_cuda.list_buffers(self.cap, K, dev)
        self.net_out = net.row_buffers(K * self.cap, opts.cdtype,
                                       device=dev)

    def lengths(self, k: int):
        """The first k counters (one copy to the host and one wait on the
        card) -> list of ints."""
        if self.ctl.device.type != "cuda":
            return self.ctl[:k].tolist()
        self.host[:k].copy_(self.ctl[:k], non_blocking=True)
        torch.cuda.current_stream(self.ctl.device).synchronize()
        return self.host[:k].tolist()

    def run(self, net, scene, opts: MarchOptions, e: int, cur: int) -> int:
        """A block of e epochs from list `cur` (0: the state's ids, 1: the
        spare), every launch over the rows' bound with the counts on the
        device -> the list the next block starts from. The block zeroes its
        counters (a copy from zeros: a copy node in a graph, where a fill
        would be a kernel), chains each epoch's list length into the next
        epoch's slot and leaves the last in slot 0."""
        K, R, k = opts.steps_per_round, self.rounds, self.block
        st, ctl, rows = self.state, self.ctl, self.rows
        lists = (st["ids"], self.spare)
        extra = scene.get("extra_dims")
        ctl[1:].copy_(self.zeros)
        for j in range(e):
            ids, nxt = lists[cur], lists[1 - cur]
            n_dev = ctl[j:j + 1]
            for r in range(R):
                c = k + 1 + j * R + r
                count = ctl[c:c + 1]
                march_cuda.walk_list(st, ids, self.cap, scene, opts,
                                     opts.advance_iters if r == 0 else None,
                                     rows, count, n_dev)
                rgb, sigma = net(rows["pos01"], rows["dir01"],
                                 compute_dtype=opts.cdtype, extra=extra,
                                 count=count, out=self.net_out)
                last = r == R - 1
                march_cuda.composite_list(
                    st, ids, self.cap, rows, count, rgb, sigma, opts,
                    nxt if last else None, ctl[j + 1:j + 2] if last else None,
                    n_dev)
            cur = 1 - cur
        ctl[:1].copy_(ctl[e:e + 1])
        return cur

    def capture(self, net, scene, opts: MarchOptions, e: int) -> BlockGraph:
        """run(e, 0) captured as a CUDA graph (capture_graph: it runs
        nothing) -> the block's graph. A capture that fails raises."""
        return capture_graph(
            lambda: self.run(net, scene, opts, e, 0),
            torch.cuda.Stream(self.ctl.device), (march_cuda, network_cuda),
            f"the list march's block of {e} epochs")[0]

    def replay(self, e: int):
        """One replay of the block of e epochs, its launches counted."""
        self.graphs[e].replay()


_LIST_CACHE: "Dict[tuple, ListMarch]" = {}


def _list_key(net: NerfNetwork, scene, opts: MarchOptions, n: int, device,
              block: int) -> tuple:
    """What a list march's graphs bake in: the frame size, the options,
    the network's config, and the address, shape and type of every
    tensor of the scene and the network that its kernels read."""
    _, grid = march_cuda.probe_route(scene, opts)
    tensors = (grid, scene["render_min"], scene["render_max"],
               scene["local"], scene["train_min"], scene["train_max"],
               scene.get("extra_dims"), net.grid, *net.density_mlp,
               *net.rgb_mlp)
    return (str(device), n, block, opts, net.config, tuple(
        None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype)
        for t in tensors))


def list_march(net: NerfNetwork, scene, opts: MarchOptions, n: int,
               device) -> ListMarch:
    """The card's cached list march for frames of n rays under these
    options, scene and network (a new one where any differs: a new
    snapshot, scene or option set captures anew) in blocks of
    BLOCK_EPOCHS."""
    block = BLOCK_EPOCHS
    key = _list_key(net, scene, opts, n, device, block)
    lm = _LIST_CACHE.pop(key, None)
    if lm is None:
        lm = ListMarch(n, opts.rounds_per_epoch, device, block)
        while len(_LIST_CACHE) >= LIST_MARCHES:
            _LIST_CACHE.pop(next(iter(_LIST_CACHE)))
    _LIST_CACHE[key] = lm
    return lm


def _frame_out(net: NerfNetwork, scene, opts: MarchOptions, n: int):
    """ray_init's `out` for a frame of n rays on the list route on the
    card (the cached list march's state), else None."""
    dev = scene["occ"].device
    if dev.type != "cuda" or not list_route(opts):
        return None
    return list_march(net, scene, opts, n, dev).state


def _march_lists(net: NerfNetwork, scene, st, opts: MarchOptions,
                 first=None, graphs=None) -> int:
    """The epochs of unbaked sequential rounds on the frame's arrays, in
    place, through each epoch's live-ray list (int32 ray ids) -> the
    epochs that found a live ray. The first list is `first`, (ids, count)
    on the device (frame_cuda.ray_init's), or the alive rays
    (torch.nonzero). A round is march_cuda.walk_list (the advance and the
    samples in an epoch's first round, the samples alone in later ones: t
    and alive written back, the valid slots' network inputs as rows), the
    network on the rows, and march_cuda.composite_list, whose last round
    of the epoch lists the rays still alive. Every launch is over the
    first list's bound with the list length and row count the kernels
    read on the device: no launch's shape follows a count. The epochs run
    in blocks of BLOCK_EPOCHS (ListMarch.run); the host reads the first list's
    length, then once after each block the length the block left and
    those that entered its epochs (which count the epochs that found a
    live ray). The epoch budget (_epoch_budget) holds: a last block takes
    the epochs left. On the card the march is a cached ListMarch
    (list_march; st copied into its state and back where st is not
    already its state, as ray_init writes it on the main path) and each
    block, with `graphs` (the default there), one replay of a CUDA graph
    captured after the first block of its size ran eagerly (BLOCK_EPOCHS
    must then be even); on the CPU the blocks run eagerly on st's
    arrays."""
    block = BLOCK_EPOCHS
    dev = st["t"].device
    n_rays = st["t"].shape[0]
    card = dev.type == "cuda"
    graphs = card if graphs is None else graphs
    if graphs and (not card or block % 2):
        raise ValueError(f"_march_lists: graphs take the card and an even "
                         f"block, got {dev} and {block}")
    if card:
        lm = list_march(net, scene, opts, n_rays, dev)
    else:
        for k in ("o", "d", "surf", "t_surf", "t_start"):
            st[k] = st[k].contiguous()
        lm = ListMarch(n_rays, opts.rounds_per_epoch, dev, block,
                       state={k: st[k] for k in _LIST_ARRAYS})
    own = lm.state
    foreign = any(st[k].data_ptr() != own[k].data_ptr() for k in _LIST_ARRAYS)
    if foreign:
        for k in _LIST_ARRAYS:
            own[k].copy_(st[k])
    if first is None:
        ids = torch.nonzero(own["alive"]).squeeze(1).to(torch.int32)
        first = (ids, torch.tensor([ids.numel()], dtype=torch.int32,
                                   device=dev))
    if "ids" not in own:            # the CPU: the caller's list itself
        own["ids"] = first[0]
    elif first[0].data_ptr() != own["ids"].data_ptr():
        own["ids"][:first[0].numel()].copy_(first[0])
    if first[1].data_ptr() != lm.ctl.data_ptr():
        lm.ctl[:1].copy_(first[1].reshape(1))
    n = lm.lengths(1)[0]
    epochs = 0
    if n:
        lm.reserve(net, opts, n, card)
        budget = _epoch_budget(opts)
        cur = 0
        while epochs < budget:
            e = min(block, budget - epochs)
            if not graphs:
                cur = lm.run(net, scene, opts, e, cur)
            elif e in lm.graphs:
                lm.replay(e)
            else:               # the block's work, then its graph for later
                lm.run(net, scene, opts, e, 0)
                lm.graphs[e] = lm.capture(net, scene, opts, e)
            seen = lm.lengths(block)
            epochs += 1 + sum(1 for x in seen[1:e] if x > 0)
            if seen[0] == 0:
                break
    if foreign:
        for k in _LIST_OUT:
            st[k].copy_(own[k])
    return epochs


# ---------------------------------------------------------------------------
# Collision march (NerfTracer::collide, testbed.cu:1814-1888 +
# check_collision, testbed.cu:721-782): march each start point along a
# shared direction until the first sample with alpha > 0; record the
# distance from the origin. Points that exit the aabb report 0.
# ---------------------------------------------------------------------------

def collide_march(net: NerfNetwork, scene, o, d, opts: MarchOptions):
    """o (N, 3) NGP-space start points; d (3,) unit direction ->
    (distances (N,), 0 where no collision; turns of the loop).

    A turn is the JAX package's while-loop body on all N points; points
    that hit or left the aabb no longer change. Each turn reads two
    flags from the device in one fetch: whether any point is still
    marching (else the loop ends, as the JAX condition ends it) and
    whether any of them stands in an occupied cell (else no point can
    hit this turn and the density network is not evaluated)."""
    n = o.shape[0]
    cfg = opts.config
    dv = d.expand(n, 3)
    idir = 1.0 / dv             # a zero component gives +-inf, as in JAX
    train_extent = scene["train_max"] - scene["train_min"]
    t = torch.zeros(n, device=o.device)
    dist = torch.zeros(n, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    turns = 0
    while turns < C.MARCH_ITER:
        pos = o + dv * t[:, None]
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, mip = _occupied(scene, pos, dt, opts)
        cand = alive & inside & occ
        any_alive, any_cand = torch.stack([alive.any(), cand.any()]).tolist()
        if not any_alive:
            break
        turns += 1
        if any_cand:
            pos01 = torch.clamp((pos - scene["train_min"]) / train_extent,
                                0.0, 1.0)
            sigma = apply_density_activation(
                net.density_raw(pos01, compute_dtype=opts.cdtype)[:, 0],
                cfg.density_activation)
            hit = cand & (1.0 - torch.exp(-sigma * dt) > 0.0)
            dist = torch.where(
                hit, torch.linalg.vector_norm(pos - o, dim=-1), dist)
            alive = alive & inside & ~hit
        else:
            alive = alive & inside
        res = C.NERF_GRIDSIZE * torch.exp2(-mip.float())
        adv = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, dv,
                                            idir, res)
        t = torch.where(alive & ~occ, adv, torch.where(alive, t + dt, t))
    return dist, turns


# ---------------------------------------------------------------------------
# Pixel rays + full-frame rendering
# ---------------------------------------------------------------------------

def camera_rays(camera: np.ndarray, width: int, height: int):
    """Packed 3x4 camera -> (N, 3) origins (+0.5 NGP shift) and unit
    dirs through the pixel centres, float32 numpy.

    NDC ray generation matching init_rays_with_payload's pixel_to_ray
    (ngp_common.cuh:362-368): dir = cam[:, :3] @ (2u-1, 2v-1, 1); row 0 is
    the bottom of the image (v = +up)."""
    cam = np.asarray(camera, np.float32)
    x = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    y = (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0 - 1.0
    xx, yy = np.meshgrid(x, y)  # (H, W)
    ndc = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    d = ndc @ cam[:, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(cam[:, 3] + 0.5, d.shape)
    return (o.reshape(-1, 3).astype(np.float32),
            d.reshape(-1, 3).astype(np.float32))


def render_image_device(net: NerfNetwork, scene, camera, width: int,
                        height: int, opts: MarchOptions, surface_rgba=None,
                        t_surface=None, sample_index: int = 0,
                        linear_colors: bool = False,
                        lens_mode: str = "perspective", lens_params=None,
                        snap_centers: bool = False, camera_end=None,
                        rolling_shutter=None, distortion_grid=None):
    """Render a frame through a packed 3x4 camera -> (framebuffer (H, W, 4)
    linear premultiplied, depth (H, W), epochs), tensors on the scene's
    device.

    Rays follow pixel_to_ray (ngp_common.cuh:336-399), row 0 the bottom
    of the image:
    - sub-pixel offsets: Halton(2, 3) of the sample index, or the pixel
      centre with snap_centers;
    - lens_mode "perspective" (dir = (2u-1, 2v-1, 1)), "opencv" (the same,
      undistorted by lens_params k1 k2 p1 p2), "ftheta" or "latlong";
    - distortion_grid (Hg, Wg, 2), the trained distortion map, added to
      dir.xy;
    - camera_end + rolling_shutter (4,): each pixel renders through
      camera * ray_time + camera_end * (1 - ray_time), ray_time = rs.x +
      rs.y u + rs.z v + rs.w rand (testbed.cu:398-406);
    - opts.aperture_size > 0: depth of field about opts.focus_z.
    Only a plain perspective camera (none of the above but the offsets)
    starts the march from the flash coarse init when opts.lowres_factor
    > 1. The shade step converts accumulated radiance sRGB -> linear
    unless `linear_colors` (shade_kernel_nerf, testbed.cu:907-931)."""
    if snap_centers:
        offsets = (0.5, 0.5)
    else:
        offsets = (_radical_inverse(2, int(sample_index) + 1),
                   _radical_inverse(3, int(sample_index) + 1))
    shutter = camera_end is not None and rolling_shutter is not None
    plain_cam = (lens_mode not in ("ftheta", "latlong", "opencv")
                 and distortion_grid is None and not shutter
                 and opts.aperture_size == 0.0)
    opts = frame_options(opts)
    rays = coarse = None
    if not plain_cam:
        rays = _lens_rays(scene, camera, width, height, opts, offsets,
                          sample_index, lens_mode, lens_params, camera_end,
                          rolling_shutter, distortion_grid)
    elif opts.lowres_factor > 1:
        cam = torch.as_tensor(np.asarray(camera, np.float32),
                              device=scene["occ"].device)
        coarse = flash_init(scene, cam, width, height, opts)
    st, first = frame_cuda.ray_init(
        scene, opts, camera, width, height, offsets, sample_index,
        surface_rgba, t_surface, coarse, make_list=list_route(opts),
        rays=rays, out=_frame_out(net, scene, opts, width * height))
    st, epochs = march_state(net, scene, st, opts, first)
    rgba, depth = frame_cuda.finalize(st["rgba"], st["depth"], width, height,
                                      linear_colors)
    return rgba, depth, epochs


def _lens_rays(scene, camera, width: int, height: int, opts: MarchOptions,
               offsets, sample_index, lens_mode, lens_params, camera_end,
               rolling_shutter, distortion_grid):
    """render_image_device's rays for a camera other than a plain
    perspective one -> (o, d) (N, 3)."""
    dev = scene["occ"].device
    f32 = dict(dtype=torch.float32, device=dev)
    npix = width * height
    cam = torch.as_tensor(np.asarray(camera, np.float32), **f32)
    shutter = camera_end is not None and rolling_shutter is not None
    ox, oy = offsets
    u = ((torch.arange(width, **f32) + ox) / width)[None].expand(height, width)
    v = ((torch.arange(height, **f32) + oy) / height)[:, None].expand(height,
                                                                      width)
    uv = torch.stack([u, v], dim=-1)
    if lens_mode in ("ftheta", "opencv"):
        lp = torch.as_tensor(np.asarray(lens_params, np.float32), **f32)
    if lens_mode == "ftheta":
        dir_cam = _f_theta_dirs(uv - 0.5, lp)
    elif lens_mode == "latlong":
        dir_cam = _latlong_dirs(uv)
    else:
        x = u * 2.0 - 1.0
        y = v * 2.0 - 1.0
        if lens_mode == "opencv":
            x, y = _opencv_undistort(x, y, lp)
        dir_cam = torch.stack([x, y, torch.ones((height, width), **f32)],
                              dim=-1)
    if distortion_grid is not None:
        grid = torch.as_tensor(np.asarray(distortion_grid, np.float32), **f32)
        dir_cam = torch.cat([dir_cam[..., :2] + _read_image2(grid, uv),
                             dir_cam[..., 2:]], dim=-1)
    dir_cam = dir_cam.reshape(-1, 3)

    if shutter:
        cam_end = torch.as_tensor(np.asarray(camera_end, np.float32), **f32)
        rs = torch.as_tensor(np.asarray(rolling_shutter, np.float32), **f32)
        pix = torch.arange(npix, dtype=torch.int64, device=dev)
        rnd = _hash_u32(mul_u32(pix, 72239731)
                        + ((int(sample_index) & U32) * 2654435761 & U32))
        ray_time = rs[0] + rs[1] * u.reshape(-1) + rs[2] * v.reshape(-1) \
            + rs[3] * rnd
        rt = ray_time[:, None, None]
        cam_px = cam[None] * rt + cam_end[None] * (1.0 - rt)     # (N, 3, 4)
        d = torch.einsum("nij,nj->ni", cam_px[:, :, :3], dir_cam)
        o = cam_px[:, :, 3] + 0.5
    else:
        d = dir_cam @ cam[:, :3].T
        o = (cam[:, 3] + 0.5).expand(d.shape)
    if opts.aperture_size > 0.0:
        # a square -> Shirley disk mapping of two per-pixel hashes
        si = int(sample_index) & U32
        pix = torch.arange(npix, dtype=torch.int64, device=dev)
        a = _hash_u32(mul_u32(pix, 2654435761) + si) * 2.0 - 1.0
        b = _hash_u32(mul_u32(pix, 805459861)
                      + ((si * 9781 + 1) & U32)) * 2.0 - 1.0
        a_wins = torch.abs(a) > torch.abs(b)
        r = torch.where(a_wins, a, b)
        phi = torch.where(
            a_wins, (np.pi / 4.0) * (b / torch.where(a == 0.0, 1.0, a)),
            (np.pi / 2.0) - (np.pi / 4.0) * (a / torch.where(b == 0.0, 1.0, b)))
        blur = opts.aperture_size * torch.stack(
            [r * torch.cos(phi), r * torch.sin(phi)], -1)           # (N, 2)
        lookat = o + d * opts.focus_z
        o = o + blur[:, :1] * cam[:, 0] + blur[:, 1:2] * cam[:, 1]
        d = (lookat - o) / opts.focus_z
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o, d


def render_image(net: NerfNetwork, scene, camera, width: int, height: int,
                 opts: MarchOptions, surface_rgba=None, t_surface=None,
                 sample_index: int = 0, linear_colors: bool = False):
    """Host-facing wrapper: render_image_device + one fetch -> numpy
    (rgba (H, W, 4), depth (H, W))."""
    rgba, depth, _ = render_image_device(
        net, scene, camera, width, height, opts, surface_rgba, t_surface,
        sample_index, linear_colors)
    return rgba.cpu().numpy(), depth.cpu().numpy()

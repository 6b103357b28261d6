"""Volumetric ray marching with occupancy-grid skipping and depth-gated
mesh-surface compositing: the exact (unbaked) path.

Port of nerf_glasses_tpu/ops/raymarch.py (the reference's NerfTracer:
init_rays_with_payload testbed.cu:355-467, advance_pos_nerf :470-537,
generate_next_nerf_network_inputs :564-633, composite_kernel_nerf
:784-905, trace loop :1938-2053).

`march_frame_impl` runs eagerly: each epoch compacts the alive rays
(one host read), walks them through empty space on occupancy lookups
alone (`_advance_pass`), then spends one K-sample round on them
(`_march_round`). Every ray's result is independent of how rays are
batched, so the epoch processes all alive rays as one batch where the
JAX package used fixed 4096-ray chunks; the network runs only on the
round's valid samples (an invalid sample composites with weight 0 in
both packages).

Mesh-surface gating, as in the reference: rays with a surface are
revived at t_surface (testbed.cu:487-493); an opaque surface stops the
march (:600-607); crossing t_surface blends the surface colour in
front-to-back order (:843-857); rays that end blend any unconsumed
surface colour with the remaining transmittance (:886-897).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops.colors import srgb_to_linear
from nerf_glasses_tpu_torch.ops.compaction import stable_partition_ids
from nerf_glasses_tpu_torch.ops.hashgrid import U32, mul_u32
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
    jitter: bool = True
    compute_dtype: str = "bfloat16"

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


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer hash of uint32 values (held in int64) -> [0, 1) f32; the
    start-t jitter (stands in for random_val.cuh ld_random_val)."""
    x = x & U32
    x = mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x.float() * (1.0 / 4294967296.0)


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


def _contains_local(pos, scene):
    return contains_aabb(pos @ scene["local"].T, scene["render_min"],
                         scene["render_max"])


def _ray_exit_t(o, d, scene):
    """Render-aabb exit distance per ray; -inf for rays that miss it."""
    _, tmax = ray_intersect_aabb(o @ scene["local"].T, d @ scene["local"].T,
                                 scene["render_min"], scene["render_max"])
    return torch.where(tmax >= 3e38, -torch.inf, tmax)


def _occupied(scene, pos, dt, opts: MarchOptions):
    if opts.config.max_cascade == 0:
        mip = torch.zeros(pos.shape[:-1], dtype=torch.int32,
                          device=pos.device)
    else:
        mip = occ_ops.mip_from_dt(dt, pos, opts.config.max_cascade)
    return occ_ops.occupied_at(scene["occ"], pos, mip), mip


def _skip_probe(scene, pos, t, d, idir, dt, opts: MarchOptions):
    """One-gather DDA probe -> (occupied, t_advanced). Single-cascade
    scenes read the jump grid, which gives the occupancy bit and the
    coarsest empty block in one uint8 gather; multi-cascade scenes probe
    their mip and step one voxel of it."""
    if opts.config.max_cascade == 0:
        lv = occ_ops.skip_level_at(scene["skip"], pos)
        occ = lv == 255
        res = C.NERF_GRIDSIZE * torch.exp2(-torch.clamp(lv, max=4).float())
    else:
        occ, mip = _occupied(scene, pos, dt, opts)
        res = C.NERF_GRIDSIZE * torch.exp2(-mip.float())
    adv = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, d, idir, res)
    return occ, adv


# ---------------------------------------------------------------------------
# Ray init (init_rays_with_payload + advance_pos_nerf)
# ---------------------------------------------------------------------------

def init_rays(scene, o, d, t_surface, opts: MarchOptions, sample_index=0):
    """o, d (N, 3): origins in NGP space (+0.5 shifted) and unit dirs ->
    (t, t_start, alive)."""
    n = o.shape[0]
    tmin, _ = ray_intersect_aabb(o, d, scene["render_min"],
                                 scene["render_max"])
    t = torch.clamp(tmin, min=0.0) + 1e-6
    alive = contains_aabb(o + d * t[:, None], scene["render_min"],
                          scene["render_max"])
    has_surface = t_surface > 0.0
    t = torch.where(~alive & has_surface, t_surface, t)
    alive = alive | has_surface

    if opts.jitter:
        ray_idx = torch.arange(n, dtype=torch.int64, device=o.device)
        seed = ((int(sample_index) & U32) * 2654435761) & U32
        jit01 = _hash_u32(mul_u32(ray_idx, 786433) + seed)
        t = t + jit01 * occ_ops.calc_dt(t, opts.cone_angle)

    idir = 1.0 / d
    settled = ~alive
    for _ in range(opts.init_skip_iters):
        pos = o + d * t[:, None]
        at_surface = has_surface & (t > t_surface)
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        newly_surface = ~settled & alive & at_surface
        newly_exit = ~settled & alive & ~at_surface & ~inside
        newly_hit = ~settled & alive & ~at_surface & inside & occ
        t = torch.where(newly_surface | (newly_exit & has_surface),
                        t_surface, t)
        alive = alive & ~(newly_exit & ~has_surface)
        settled = settled | newly_surface | newly_exit | newly_hit | ~alive
        t = torch.where(~settled & alive, adv, t)

    in_mip0 = occ_ops.mip_from_pos(o + d * t[:, None],
                                   opts.config.max_cascade) == 0
    t_start = torch.where(in_mip0, t, 0.0)
    return t, t_start, alive


def _make_state(scene, o, d, surface_rgba, t_surface, opts, sample_index):
    t0, t_start, alive0 = init_rays(scene, o, d, t_surface, opts,
                                    sample_index)
    n = o.shape[0]
    return {
        # per-ray constants
        "o": o, "d": d, "surf": surface_rgba, "t_surf": t_surface,
        "t_start": t_start,
        # march state
        "t": t0,
        "rgba": torch.zeros((n, 4), device=o.device),
        "depth": torch.zeros((n,), device=o.device),
        "max_weight": torch.zeros((n,), device=o.device),
        "alive": alive0,
        "surf_a": torch.where(alive0, surface_rgba[:, 3], 0.0),
    }


# ---------------------------------------------------------------------------
# Advance pass: move rays through empty space to the next occupied voxel
# without network rounds. Rays exiting the aabb with no pending surface
# die; rays with a pending surface are parked at t_surface.
# ---------------------------------------------------------------------------

def _advance_pass(st, scene, opts: MarchOptions, iters: int):
    o, d = st["o"], st["d"]
    idir = 1.0 / d
    t_surface = st["t_surf"]
    surf_live = (t_surface > 0.0) & (st["surf_a"] > 0.0)
    t_exit = _ray_exit_t(o, d, scene)
    t, alive = st["t"], st["alive"]
    settled = ~alive
    for _ in range(iters):
        active = ~settled & alive
        pos = o + d * t[:, None]
        surf_pending = surf_live & (t >= t_surface)
        inside = t <= t_exit
        dt = occ_ops.calc_dt(t - st["t_start"], opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        newly_park = active & (surf_pending | (~inside & surf_live))
        newly_exit = active & ~surf_pending & ~inside & ~surf_live
        newly_hit = active & ~surf_pending & inside & occ
        t = torch.where(newly_park, t_surface, t)
        alive = alive & ~newly_exit
        settled = settled | newly_park | newly_hit | ~alive
        t = torch.where(~settled & alive, adv, t)
    return {**st, "t": t, "alive": alive}


# ---------------------------------------------------------------------------
# One K-sample round on a ray-state dict
# ---------------------------------------------------------------------------

def _march_round(st, net: NerfNetwork, scene, opts: MarchOptions):
    """Generate up to K samples per ray, evaluate the network on the
    valid ones, composite (composite_kernel_nerf semantics)."""
    cfg = opts.config
    K = opts.steps_per_round
    o, d = st["o"], st["d"]
    n = o.shape[0]
    idir = 1.0 / d
    t_surface = st["t_surf"]
    surface_rgba = st["surf"]
    t_start = st["t_start"]
    has_surface = t_surface > 0.0
    alive = st["alive"]
    surf_a = st["surf_a"]

    # --- sample generation: K sequential steps of <= skip_iters probes
    t, gen_alive = st["t"], alive
    exited = torch.zeros_like(alive)
    surf_stopped = torch.zeros_like(alive)
    pos_k, dt_k, valid_k, ts_k = [], [], [], []
    for _ in range(K):
        status = torch.where(gen_alive, 0, -1)
        for _ in range(opts.skip_iters):
            active = status == 0
            pos = o + d * t[:, None]
            surf_stop = has_surface & (t > t_surface) & (surf_a >= 1.0)
            inside = _contains_local(pos, scene)
            dt = occ_ops.calc_dt(t - t_start, opts.cone_angle)
            occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
            new_status = torch.where(surf_stop, 3, torch.where(
                ~inside, 2, torch.where(occ, 1, 0)))
            status = torch.where(active, new_status, status)
            t = torch.where(active & (status == 0), adv, t)
        found = status == 1
        pos_k.append(o + d * t[:, None])
        dt = occ_ops.calc_dt(t - t_start, opts.cone_angle)
        dt_k.append(dt)
        valid_k.append(found & alive)
        ts_k.append(t)
        exited |= status == 2
        surf_stopped |= status == 3
        t = torch.where(found, t + dt, torch.where(status == 3, t_surface, t))
        gen_alive = gen_alive & (found | (status == 0))
    t_end = t
    exited = exited & alive
    surf_stopped = surf_stopped & alive
    terminated_early = exited | surf_stopped

    # --- network on the round's valid samples (K, n) -------------------
    valid = torch.stack(valid_k)
    rgb_s = torch.zeros((K, n, 3), device=o.device)
    alpha_k = torch.zeros((K, n), device=o.device)
    sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
    if sel.numel():
        pos = torch.stack(pos_k).reshape(-1, 3)[sel]
        pos01 = (pos - scene["train_min"]) / (scene["train_max"]
                                              - scene["train_min"])
        dir01 = ((d + 1.0) * 0.5).repeat(K, 1)[sel]
        rgb_raw, sigma_raw = net(pos01, dir01, compute_dtype=opts.cdtype)
        sigma = apply_density_activation(sigma_raw, cfg.density_activation)
        rgb_s.view(-1, 3)[sel] = apply_rgb_activation(rgb_raw,
                                                      cfg.rgb_activation)
        alpha_k.view(-1)[sel] = 1.0 - torch.exp(
            -sigma * torch.stack(dt_k).reshape(-1)[sel])

    # --- in-march surface blend: once, before the round's samples, for
    # rays whose payload-t has crossed t_surface (testbed.cu:843-857)
    rgba = st["rgba"]
    comp_alive = alive
    t_payload = torch.where(exited, st["t"],
                            torch.where(surf_stopped, t_surface, t_end))
    trigger = comp_alive & has_surface & (t_payload > t_surface) & (surf_a > 0.0)
    T = 1.0 - rgba[:, 3]
    blend = torch.cat([surface_rgba[:, :3] * (surf_a * T)[:, None],
                       (surf_a * T)[:, None]], dim=-1)
    rgba = torch.where(trigger[:, None], rgba + blend, rgba)
    surf_a = torch.where(trigger, 0.0, surf_a)
    sat = trigger & (rgba[:, 3] > 0.99)
    rgba = rgba * torch.where(
        sat, 1.0 / torch.clamp(rgba[:, 3], min=1e-9), 1.0)[:, None]
    comp_alive = comp_alive & ~sat

    # --- front-to-back composite of the K samples ----------------------
    depth, max_w = st["depth"], st["max_weight"]
    for k in range(K):
        use = comp_alive & valid[k]
        w = torch.where(use, alpha_k[k] * (1.0 - rgba[:, 3]), 0.0)
        rgba = rgba + torch.cat([rgb_s[k] * w[:, None], w[:, None]], dim=-1)
        done = use & (rgba[:, 3] > 1.0 - opts.min_transmittance)
        upd = w > max_w
        max_w = torch.where(upd, w, max_w)
        depth = torch.where(upd & use, ts_k[k], depth)
        rgba = rgba * torch.where(
            done, 1.0 / torch.clamp(rgba[:, 3], min=1e-9), 1.0)[:, None]
        comp_alive = comp_alive & ~done

    # final surface blend for rays that ended (testbed.cu:886-897)
    fin = comp_alive & terminated_early & (surf_a > 0.0)
    rgba = torch.where(fin[:, None],
                       rgba + surface_rgba * (1.0 - rgba[:, 3:4]), rgba)
    comp_alive = comp_alive & ~terminated_early
    return {**st, "t": t_end, "rgba": rgba, "depth": depth,
            "max_weight": max_w, "alive": comp_alive, "surf_a": surf_a}


def _finalize(st):
    rgba = st["rgba"]
    keep = rgba[:, 3] > 0.001   # compact_kernel_nerf's w > 0.001 filter
    rgba = torch.where(keep[:, None], rgba, 0.0)
    # depth only where the splat alpha exceeds 0.2 (shade_kernel_nerf,
    # testbed.cu:927-929); else the cleared 0
    depth = torch.where(rgba[:, 3] > 0.2, st["depth"], 0.0)
    return {"rgba": rgba, "depth": depth}


_GATHER = ("o", "d", "surf", "t_surf", "t_start", "t", "rgba", "depth",
           "max_weight", "surf_a")
_SCATTER = ("t", "rgba", "depth", "max_weight", "alive", "surf_a")


def march_frame_impl(net: NerfNetwork, scene, o, d, surface_rgba, t_surface,
                     opts: MarchOptions, sample_index=0):
    """March a whole frame -> ({"rgba" (N, 4), "depth" (N,)}, epochs).

    With constant dt on a single cascade the init DDA is skipped: the
    per-epoch advance pass performs the identical quantized stepping (and
    the results depend on this choice, as in the reference package)."""
    if opts.cone_angle == 0.0 and opts.config.max_cascade == 0:
        opts = dataclasses.replace(opts, init_skip_iters=0)
    st = _make_state(scene, o, d, surface_rgba, t_surface, opts,
                     sample_index)
    epochs = 0
    while epochs < max(1, opts.max_rounds):
        perm, n_alive = stable_partition_ids(st["alive"])
        if n_alive == 0:
            break
        ids = perm[:n_alive]
        sub = {k: st[k][ids] for k in _GATHER}
        sub["alive"] = torch.ones(n_alive, dtype=torch.bool, device=o.device)
        sub = _advance_pass(sub, scene, opts, opts.advance_iters)
        sub = _march_round(sub, net, scene, opts)
        for k in _SCATTER:
            st[k][ids] = sub[k]
        epochs += 1
    return _finalize(st), epochs


# ---------------------------------------------------------------------------
# Pixel rays + full-frame rendering
# ---------------------------------------------------------------------------

def render_image_device(net: NerfNetwork, scene, camera, width: int,
                        height: int, opts: MarchOptions, surface_rgba=None,
                        t_surface=None, sample_index: int = 0,
                        linear_colors: bool = False):
    """Render a frame through a plain perspective packed 3x4 camera ->
    (framebuffer (H, W, 4) linear premultiplied, depth (H, W), epochs),
    tensors on the scene's device.

    Rays follow pixel_to_ray (ngp_common.cuh:336-399) with per-sample
    Halton(2, 3) sub-pixel offsets; dir = cam[:, :3] @ (2u-1, 2v-1, 1),
    row 0 the bottom of the image. The shade step converts accumulated
    radiance sRGB -> linear unless `linear_colors` (shade_kernel_nerf,
    testbed.cu:907-931)."""
    dev = scene["occ"].device
    f32 = dict(dtype=torch.float32, device=dev)
    npix = width * height
    cam = torch.as_tensor(np.asarray(camera, np.float32), **f32)
    ox = _radical_inverse(2, int(sample_index) + 1)
    oy = _radical_inverse(3, int(sample_index) + 1)
    u = (torch.arange(width, **f32) + ox) / width
    v = (torch.arange(height, **f32) + oy) / height
    dir_cam = torch.stack([(u * 2.0 - 1.0)[None].expand(height, width),
                           (v * 2.0 - 1.0)[:, None].expand(height, width),
                           torch.ones((height, width), **f32)], dim=-1)
    d = dir_cam.reshape(-1, 3) @ cam[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = (cam[:, 3] + 0.5).expand(d.shape)
    if surface_rgba is None:
        surf = torch.zeros((npix, 4), **f32)
        tsurf = torch.zeros((npix,), **f32)
    else:
        surf = surface_rgba.reshape(npix, 4)
        tsurf = t_surface.reshape(npix)
    out, epochs = march_frame_impl(net, scene, o, d, surf, tsurf, opts,
                                   sample_index)
    rgba = out["rgba"].reshape(height, width, 4)
    depth = out["depth"].reshape(height, width)
    return _shade_frame(rgba, linear_colors), depth, epochs


def _shade_frame(rgba, linear_colors: bool):
    if linear_colors:
        return rgba
    return torch.cat([srgb_to_linear(rgba[..., :3]), rgba[..., 3:]], dim=-1)


def render_image(net: NerfNetwork, scene, camera, width: int, height: int,
                 opts: MarchOptions, surface_rgba=None, t_surface=None,
                 sample_index: int = 0, linear_colors: bool = False):
    """Host-facing wrapper: render_image_device + one fetch -> numpy
    (rgba (H, W, 4), depth (H, W))."""
    rgba, depth, _ = render_image_device(
        net, scene, camera, width, height, opts, surface_rgba, t_surface,
        sample_index, linear_colors)
    return rgba.cpu().numpy(), depth.cpu().numpy()

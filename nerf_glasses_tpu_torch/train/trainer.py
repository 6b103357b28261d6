"""Hash-grid NeRF training (Instant-NGP semantics) in PyTorch.

Port of nerf_glasses_tpu/train/trainer.py, the default TrainOptions path:

- pixels drawn uniformly over (image, pixel), or by inverse CDF over a
  per-image error raster once past its warmup;
- rays through an occupancy-DDA hop pass that measures each ray's
  occupied length, then `samples_per_ray` stratified samples placed by
  inverse CDF over the occupied segments;
- optionally a transmittance-prefix keep set from a stop-grad density
  forward of the live network, so that the full network (and its hash
  table gradient) runs on a bucket of the samples only;
- hash grid -> density MLP -> SH (+ per-image latent codes) -> rgb MLP,
  front-to-back composite against a random background or a trainable
  envmap, the tcnn loss menu, depth supervision;
- the backward pass by autograd (the hash gathers' gradient is an index
  scatter-add into the table; on the card the network's forward and
  backward are the hand kernels of ops/network_cuda.py, through its
  autograd Functions), Adam with tcnn's hyperparameters and
  ExponentialDecay, l2_reg on the MLP weights only (one launch of the
  ops/adam_cuda.py kernel on the card, which reads the step's learning
  rate from device memory);
- every `grid_update_interval` steps an EMA decay plus scatter-max of
  optical thickness into the density grid, and the occupancy rebuild;
- the trainable auxiliary models (upstream's per-image AdamOptimizers
  and TrainableBuffers, testbed.cu:1027-1304): per-image extrinsics
  offsets (axis-angle rotation + translation, with an L2 anchor), a
  distortion raster added to the camera-plane ray coordinates, a
  lat-long envmap as the background, per-image exposure (re-centred to
  zero mean) and per-image latent codes, each with its own Adam and
  learning rate. The rays of the geometry pass see the aux models
  detached; the loss differentiates the network and the aux together.

Every function that draws randomness is split into a draw from an
explicit `torch.Generator` (`draw_pixels`, `draw_step`,
`draw_grid_update`) and a deterministic body that takes the draws as
tensors, so that the JAX package's own draws can be fed to the bodies.
The step loop is plain Python with no host read per step: losses stay
on the device and come back in one fetch per `train` call. The step
keeps its state in place (parameters, moments, the density grid and
occupancy, the error map, the loss EMA), so that on the card
`Trainer.train` replays a settled step as one captured CUDA graph (the
rule is in `Trainer.train`'s docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io.dataset import NerfDataset
from nerf_glasses_tpu_torch.ops import adam_cuda, march_cuda, network_cuda
from nerf_glasses_tpu_torch.ops import raymarch
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb
from nerf_glasses_tpu_torch.ops.compaction import stable_partition_perm
from nerf_glasses_tpu_torch.ops.network import (NerfNetwork,
                                                apply_density_activation,
                                                apply_rgb_activation,
                                                init_params)
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox

G = C.NERF_GRIDSIZE


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    """The JAX package's TrainOptions: same fields, same defaults (see
    the comments there for each field's measured reason)."""
    config: NGPConfig
    rays_per_batch: int = 1 << 11
    samples_per_ray: int = 48
    march_hops: int = 128
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-15
    l2_reg: float = 1e-6
    lr_decay: float = 1.0
    lr_decay_start: int = 0
    lr_decay_interval: int = 1000
    loss_type: str = "l2"
    huber_delta: float = 0.1
    random_bg: bool = True
    density_grid_decay: float = 0.95
    grid_update_interval: int = 16
    grid_samples_per_update: int = 1 << 18
    cone_angle: float = 0.0
    compute_dtype: str = "bfloat16"
    # hash-encode trilinear-sum dtype of the training network evals and
    # of the density-grid refresh (tcnn tables are fp16)
    encode_dtype: str = "bfloat16"
    # iterative OpenCV undistortion of training rays (turned on by the
    # Trainer when the dataset carries k1/k2/p1/p2)
    apply_lens_distortion: bool = False
    # trainable auxiliary models; latent codes train whenever
    # config.n_extra_learnable_dims > 0
    optimize_extrinsics: bool = False
    extrinsics_lr: float = 1e-4
    extrinsics_l2_reg: float = 1e-3
    optimize_distortion: bool = False
    distortion_resolution: int = 32
    distortion_lr: float = 1e-4
    train_envmap: bool = False
    envmap_resolution: tuple = (32, 64)
    envmap_lr: float = 1e-2
    extra_dims_lr: float = 1e-3
    # error-map importance sampling after a uniform warmup
    sample_error_map: bool = True
    error_map_resolution: int = 32
    error_map_warmup: int = 256
    error_map_beta: float = 0.1
    error_map_floor: float = 0.2
    optimize_exposure: bool = False
    exposure_lr: float = 1e-3
    # -1 = 1.0 when the dataset carries depth images, else off
    depth_supervision_lambda: float = -1.0
    # transmittance-prefix sample compaction (0 = off) and its gate
    compact_keep_fraction: float = 1.0 / 3.0
    compact_T_eps: float = 1e-5
    compact_occ_frac_gate: float = 0.2

    @property
    def cdtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    @property
    def edtype(self):
        return torch.bfloat16 if self.encode_dtype == "bfloat16" \
            else torch.float32


def adam_init(net: NerfNetwork):
    return {k: {n: torch.zeros_like(p) for n, p in net.named_parameters()}
            for k in ("m", "v")}


def make_aux(opts: TrainOptions, n_images: int, device="cpu"
             ) -> Dict[str, torch.Tensor]:
    """The trainable auxiliary models the options ask for, at their
    initial values: cam_rot and cam_trans (n, 3) zeros, distortion (R, R,
    2) zeros, envmap (he, we, 3) at 0.5, extra_dims (n, E) zeros,
    exposure (n, 3) zeros."""
    if n_images <= 0 and (opts.optimize_extrinsics or opts.optimize_exposure
                          or opts.config.n_extra_learnable_dims):
        raise ValueError("per-image aux models need the image count")
    dev = torch.device(device)
    aux = {}
    if opts.optimize_extrinsics:
        aux["cam_rot"] = torch.zeros((n_images, 3), device=dev)
        aux["cam_trans"] = torch.zeros((n_images, 3), device=dev)
    if opts.optimize_distortion:
        R = opts.distortion_resolution
        aux["distortion"] = torch.zeros((R, R, 2), device=dev)
    if opts.train_envmap:
        he, we = opts.envmap_resolution
        aux["envmap"] = torch.full((he, we, 3), 0.5, device=dev)
    if opts.config.n_extra_learnable_dims:
        aux["extra_dims"] = torch.zeros(
            (n_images, opts.config.n_extra_learnable_dims), device=dev)
    if opts.optimize_exposure:
        aux["exposure"] = torch.zeros((n_images, 3), device=dev)
    return aux


def make_train_state(opts: TrainOptions, aabb_min, aabb_max,
                     n_images: int, generator: torch.Generator,
                     device="cpu") -> Dict[str, object]:
    """Fresh training state: a network drawn from `generator` with
    gradients on, zero Adam moments, the auxiliary models (make_aux) and
    their zero moments, a zero density grid and an all-on occupancy
    (warmup), the error raster, the loss EMA and the keep-set overflow
    counters, all tensors on `device`."""
    dev = torch.device(device)
    net = init_params(opts.config, generator, dev).requires_grad_(True)
    n_casc = opts.config.max_cascade + 1
    aux = make_aux(opts, n_images, dev)
    state = {
        "net": net,
        "opt": adam_init(net),
        "aux": aux,
        "aux_opt": {k: {n: torch.zeros_like(a) for n, a in aux.items()}
                    for k in ("m", "v")},
        "step": 0,
        "density_grid": torch.zeros((n_casc, G, G, G), device=dev),
        "occ": torch.ones((C.NERF_CASCADES, G, G, G), dtype=torch.uint8,
                          device=dev),
        "aabb_min": torch.as_tensor(np.asarray(aabb_min, np.float32),
                                    device=dev),
        "aabb_max": torch.as_tensor(np.asarray(aabb_max, np.float32),
                                    device=dev),
        "loss_ema": torch.zeros((), device=dev),
        # compacted steps whose keep set outgrew the bucket, and the kept
        # samples those steps dropped (the JAX package drops them silently)
        "overflow_steps": torch.zeros((), dtype=torch.int64, device=dev),
        "overflow_samples": torch.zeros((), dtype=torch.int64, device=dev),
    }
    if opts.sample_error_map and n_images > 0:
        R = opts.error_map_resolution
        state["error_map"] = torch.ones((n_images, R, R), device=dev)
    return state


def prepare_dataset_arrays(ds: NerfDataset, device="cpu"
                           ) -> Dict[str, torch.Tensor]:
    """Stack the dataset's images and cameras into tensors on `device`.

    LDR images are supervised in sRGB (upstream's set_image converts, and
    the renderer's shade step treats the MLP's colour as sRGB): linear
    premultiplied -> unpremultiply -> sRGB -> premultiply. HDR datasets
    stay linear."""
    if ds.images is None or len(ds.images) != ds.n_images:
        raise ValueError("the dataset carries no training images")
    images = np.stack(ds.images).astype(np.float32)   # (N, H, W, 4)
    if not ds.is_hdr:
        a = images[..., 3:4]
        rgb = np.divide(images[..., :3], a, out=np.zeros_like(images[..., :3]),
                        where=a > 1e-8)
        rgb = linear_to_srgb(torch.from_numpy(np.clip(rgb, 0.0, 1.0))).numpy()
        images = np.concatenate([rgb * a, a], axis=-1)
    h, w = images.shape[1:3]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = {}
    depths = ds.depth_images
    if depths is not None and any(d is not None for d in depths):
        out["depths"] = t(np.stack([np.zeros((h, w), np.float32) if d is None
                                    else np.asarray(d, np.float32)
                                    for d in depths]))
    md = ds.metadata
    return {
        **out,
        "images": t(images),
        "xforms": t(ds.xforms),
        "fx": t([m.focal_length[0] for m in md]),
        "fy": t([m.focal_length[1] for m in md]),
        "cx": t([m.principal_point[0] for m in md]) * w,
        "cy": t([m.principal_point[1] for m in md]) * h,
        "dist": t([m.lens_params[:4] if m.lens_mode == "opencv"
                   else (0.0, 0.0, 0.0, 0.0) for m in md]),
    }


def dataset_has_distortion(ds: NerfDataset) -> bool:
    return any(m.lens_mode == "opencv" and any(m.lens_params[:4])
               for m in ds.metadata)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def draw_pixels(gen: torch.Generator, n_rays: int, n_img: int, h: int,
                w: int, error_map: bool, device) -> Dict[str, torch.Tensor]:
    """The pixel sampler's draws: uniform (img, px, py) and, with an
    error map, the inverse-CDF uniform `u_cdf` and sub-cell (ux, uy)."""
    def ri(hi):
        return torch.randint(0, hi, (n_rays,), generator=gen, device=device)

    d = {"img": ri(n_img), "px": ri(w), "py": ri(h)}
    if error_map:
        for k in ("u_cdf", "ux", "uy"):
            d[k] = torch.rand((n_rays,), generator=gen, device=device)
    return d


def draw_step(gen: torch.Generator, state, data, opts: TrainOptions):
    """All draws of one training step: pixels, the stratified sample
    offsets `u` (S, B) and the random background `bg` (B, 3)."""
    n_img, h, w = data["images"].shape[:3]
    B, S = opts.rays_per_batch, opts.samples_per_ray
    dev = data["images"].device
    d = draw_pixels(gen, B, n_img, h, w, "error_map" in state, dev)
    d["u"] = torch.rand((S, B), generator=gen, device=dev)
    if opts.random_bg:
        d["bg"] = torch.rand((B, 3), generator=gen, device=dev)
    return d


def step_draw_buffers(data, opts: TrainOptions, error_map: bool):
    """Empty tensors of one step's draws (draw_step's keys, shapes and
    types) on the images' device, for draw_step_into."""
    B, S = opts.rays_per_batch, opts.samples_per_ray
    dev = data["images"].device
    out = {k: torch.empty((B,), dtype=torch.int64, device=dev)
           for k in ("img", "px", "py")}
    if error_map:
        for k in ("u_cdf", "ux", "uy"):
            out[k] = torch.empty((B,), device=dev)
    out["u"] = torch.empty((S, B), device=dev)
    if opts.random_bg:
        out["bg"] = torch.empty((B, 3), device=dev)
    return out


def draw_step_into(gen: torch.Generator, out, data):
    """draw_step's draws written in place into `out` (step_draw_buffers),
    in draw_step's order: `random_` and `uniform_` on the generator give
    torch.randint's and torch.rand's values -> out."""
    n_img, h, w = data["images"].shape[:3]
    for k, hi in (("img", n_img), ("px", w), ("py", h)):
        out[k].random_(0, hi, generator=gen)
    for k in ("u_cdf", "ux", "uy", "u", "bg"):
        if k in out:
            out[k].uniform_(0.0, 1.0, generator=gen)
    return out


def draw_grid_update(gen: torch.Generator, n: int, n_casc: int, device):
    """The density-grid refresh's draws: cascade (n,), cell (n, 3) and
    jitter (n, 3)."""
    return {"casc": torch.randint(0, n_casc, (n,), generator=gen,
                                  device=device),
            "cell": torch.randint(0, G, (n, 3), generator=gen, device=device),
            "jitter": torch.rand((n, 3), generator=gen, device=device)}


# ---------------------------------------------------------------------------
# Ray sampling and marching
# ---------------------------------------------------------------------------

def _sample_pixels(draws, data, error_map=None, step: int = 0,
                   opts: TrainOptions = None):
    """-> (img (B,), px (B,), py (B,), target rgba (B, 4)). With an error
    map and `step` past its warmup, pixels come by inverse CDF over the
    flat (image, cell) raster plus a uniform floor; else uniformly."""
    images = data["images"]
    h, w = images.shape[1:3]
    img, px, py = draws["img"], draws["px"], draws["py"]
    if error_map is not None and step >= opts.error_map_warmup:
        N, Rh, Rw = error_map.shape
        wts = error_map.reshape(-1)
        wts = wts + opts.error_map_floor * (torch.mean(wts) + 1e-12)
        cdf = torch.cumsum(wts, 0)
        r = draws["u_cdf"] * cdf[-1]
        idx = torch.clamp(torch.searchsorted(cdf, r, right=True),
                          0, N * Rh * Rw - 1)
        img = idx // (Rh * Rw)
        rest = idx % (Rh * Rw)
        cy, cx = rest // Rw, rest % Rw
        px = torch.clamp(((cx + draws["ux"]) * (w / Rw)).long(), max=w - 1)
        py = torch.clamp(((cy + draws["uy"]) * (h / Rh)).long(), max=h - 1)
    return img, px, py, images[img, py, px]


def _error_map_accum(error_map, img, px, py, per_ray_err, w: int, h: int):
    """Per-batch (sum, count) rasters of per-ray error at the map's
    resolution."""
    N, Rh, Rw = error_map.shape
    cx = torch.clamp((px * Rw) // w, 0, Rw - 1)
    cy = torch.clamp((py * Rh) // h, 0, Rh - 1)
    sum_g = torch.zeros_like(error_map).index_put_(
        (img, cy, cx), per_ray_err, accumulate=True)
    cnt_g = torch.zeros_like(error_map).index_put_(
        (img, cy, cx), torch.ones_like(per_ray_err), accumulate=True)
    return sum_g, cnt_g


def _error_map_apply(error_map, sum_g, cnt_g, beta: float):
    mean = sum_g / torch.clamp(cnt_g, min=1.0)
    return torch.where(cnt_g > 0, (1.0 - beta) * error_map + beta * mean,
                       error_map)


def _rotate_small(rv, v):
    """Rodrigues rotation of v (B, 3) by axis-angle rv (B, 3), in
    sinc-style factors so that the gradient is finite at rv = 0, where
    the per-image offsets start (RotationAdamOptimizer's variable,
    adam_optimizer.h:96-159). torch.where differentiates both branches,
    so the large-angle branch takes a clamped t2."""
    t2 = torch.sum(rv * rv, dim=-1, keepdim=True)
    small = t2 < 1e-8
    t2c = torch.clamp(t2, min=1e-8)
    theta = torch.sqrt(t2c)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    cosf = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2c)
    rxv = torch.linalg.cross(rv, v, dim=-1)
    return v + sinc * rxv + cosf * torch.linalg.cross(rv, rxv, dim=-1)


def _bilinear2d(grid, u, v):
    """Sample an (H, W, Cc) raster at continuous uv in [0, 1] -> (B, Cc).
    The corners are row gathers from a flat view (index_select), whose
    backward is an index_add."""
    H, W = grid.shape[:2]
    x = torch.clamp(u * W - 0.5, 0.0, W - 1.0)
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    flat = grid.reshape(H * W, -1)

    def at(yi, xi):
        return flat.index_select(0, yi * W + xi)

    return ((at(y0, x0) * (1 - fx) + at(y0, x1) * fx) * (1 - fy)
            + (at(y1, x0) * (1 - fx) + at(y1, x1) * fx) * fy)


def _sample_envmap_dir(env, d):
    """The trainable lat-long envmap (H, W, 3) at ray dirs (B, 3), in
    utils/lens.dir_to_latlong's convention."""
    theta = torch.asin(torch.clamp(d[:, 1], -1.0, 1.0))
    phi = torch.atan2(d[:, 0], d[:, 2])
    u = phi / (2 * np.pi) + 0.5
    v = theta / np.pi + 0.5
    return _bilinear2d(env, u, v)


def _gen_rays(data, img, px, py, aux, apply_lens_distortion: bool):
    """Pixel indices -> world rays (o (B, 3), unit d (B, 3)), with the
    iterative OpenCV undistortion when asked, and differentiable in the
    aux models present in `aux`: the distortion raster (added to the
    camera-plane coordinates) and the per-image extrinsics offsets."""
    h, w = data["images"].shape[1:3]
    fx = data["fx"][img]
    fy = data["fy"][img]
    xd = (px + 0.5 - data["cx"][img]) / fx
    yd = (py + 0.5 - data["cy"][img]) / fy
    if apply_lens_distortion:
        kk = data["dist"][img]
        xu, yu = xd, yd
        for _ in range(10):
            r2 = xu * xu + yu * yu
            radial = 1.0 + r2 * (kk[:, 0] + kk[:, 1] * r2)
            dx = 2 * kk[:, 2] * xu * yu + kk[:, 3] * (r2 + 2 * xu * xu)
            dy = kk[:, 2] * (r2 + 2 * yu * yu) + 2 * kk[:, 3] * xu * yu
            xu = (xd - dx) / radial
            yu = (yd - dy) / radial
        xd, yd = xu, yu
    if "distortion" in aux:
        duv = _bilinear2d(aux["distortion"], (px + 0.5) / w, (py + 0.5) / h)
        xd = xd + duv[:, 0]
        yd = yd + duv[:, 1]
    dirs = torch.stack([xd, yd, torch.ones_like(xd)], dim=-1)
    xf = data["xforms"][img]                           # (B, 3, 4)
    d = torch.einsum("bij,bj->bi", xf[:, :, :3], dirs)
    o = xf[:, :, 3]
    if "cam_rot" in aux:
        # row gathers whose backward is an index_add
        d = _rotate_small(aux["cam_rot"].index_select(0, img), d)
        o = o + aux["cam_trans"].index_select(0, img)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o, d


def _check_batch(draws, n_rays: int):
    if draws["img"].shape[0] != n_rays:
        raise ValueError(f"draws hold {draws['img'].shape[0]} rays, "
                         f"expected {n_rays}")


def _sample_rays(draws, data, n_rays: int,
                 apply_lens_distortion: bool = False):
    """-> (o (B, 3), unit d (B, 3), target rgba (B, 4)) of uniformly drawn
    pixels (draw_pixels), without the aux models."""
    _check_batch(draws, n_rays)
    img, px, py, target = _sample_pixels(draws, data)
    o, d = _gen_rays(data, img, px, py, {}, apply_lens_distortion)
    return o, d, target


def march_training_samples(occ, o, d, u, opts: TrainOptions, aabb_min,
                           aabb_max, max_cascade: int):
    """Occupancy-compacted stratified training samples (no gradient).
    -> dict(t (S, B), dt (S, B), valid (S, B)); `u` (S, B) uniform, S =
    opts.samples_per_ray.

    Pass 1 hops each ray opts.march_hops times through the occupancy grid
    and records the occupied segments; pass 2 places S stratified samples
    by inverse CDF over the occupied length. On a CUDA tensor one launch
    of the nmr_training_samples kernel, on a CPU tensor its plain version
    (ops/march_cuda.py::training_samples_reference)."""
    if u.shape[0] != opts.samples_per_ray:
        raise ValueError(f"u holds {u.shape[0]} samples a ray, the options "
                         f"{opts.samples_per_ray}")
    return march_cuda.training_samples(occ, o, d, u, aabb_min, aabb_max,
                                       max_cascade, opts.cone_angle,
                                       opts.march_hops)


def compact_bucket(n_samples: int, fraction: float) -> int:
    """Compacted batch size: `fraction` of the dense sample count, rounded
    up to 2048, capped at dense."""
    b = int(np.ceil(n_samples * fraction / 2048.0)) * 2048
    return min(max(b, 2048), n_samples)


def _pos01(samples, o, d, aabb_min, aabb_max):
    pos = o[None] + d[None] * samples["t"][..., None]           # (S, B, 3)
    pos01 = (pos - aabb_min) / (aabb_max - aabb_min)
    return torch.where(samples["valid"][..., None], pos01, 0.5)


def compact_sample_sel(state, data, img, px, py, samples,
                       opts: TrainOptions):
    """Transmittance-prefix keep set and compaction ids, from a stop-grad
    density forward of the live network (no SH, no colour MLP).

    -> (sel (bucket,) flat sample ids, keep (S, B) bool, n_keep int64
    tensor). The kept samples come first in sel, in order; when n_keep
    exceeds the bucket the deepest kept samples drop (the trainer counts
    that), and when it falls short sel's tail holds dead ids."""
    S, B = samples["dt"].shape
    with torch.no_grad():
        o, d = _gen_rays(data, img, px, py, state["aux"],
                         opts.apply_lens_distortion)
        pos01 = _pos01(samples, o, d, state["aabb_min"], state["aabb_max"])
        raw = state["net"].density_raw(pos01.reshape(-1, 3), opts.cdtype,
                                       opts.edtype)[:, 0]
        sigma = apply_density_activation(raw.reshape(S, B),
                                         opts.config.density_activation)
        alpha = torch.where(samples["valid"],
                            1.0 - torch.exp(-sigma * samples["dt"]), 0.0)
        T_ex = _exclusive_cumprod(1.0 - alpha)
        keep = samples["valid"] & (T_ex > opts.compact_T_eps)
        perm = stable_partition_perm(keep.reshape(-1))
        bucket = compact_bucket(S * B, opts.compact_keep_fraction)
        return perm[:bucket], keep, keep.sum()


def _exclusive_cumprod(x):
    """(S, B) -> exclusive product over axis 0 (first row ones). Where x
    lies on the card and needs a gradient, the product is _Cumprod's."""
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        prod = _Cumprod.apply(x)
    else:
        prod = torch.cumprod(x, 0)
    return torch.cat([torch.ones_like(x[:1]), prod[:-1]], 0)


class _Cumprod(torch.autograd.Function):
    """torch.cumprod(x, 0) with a backward that reads nothing back to the
    host: aten's asks the host whether x holds a zero (a read that a
    captured CUDA graph cannot hold). The same gradient without the
    read: in a column with no zero, aten's own formula (the reversed
    cumulative sum of out * grad over x, the same operations); before a
    column's first zero z the same; at z, prod_{j<z} x_j times
    sum_{i>=z} grad_i prod_{z<j<=i} x_j; after z, zero."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, 0)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        simple = (out * grad).flip(0).cumsum(0).flip(0).div(x)
        seen = (x == 0).cumsum(0)
        first = (x == 0) & (seen == 1)
        before = seen == 0
        tail = torch.cumprod(torch.where(before | first, 1.0, x), 0)
        at = (torch.where(first, torch.cat([torch.ones_like(out[:1]),
                                            out[:-1]], 0), 0.0).sum(0)
              * torch.where(before, 0.0, grad * tail).sum(0))
        return torch.where(before, simple, torch.where(first, at[None], 0.0))


def forward_rays(net: NerfNetwork, samples, o, d, bg, opts: TrainOptions,
                 aabb_min, aabb_max, extra=None, exposure_scale=None,
                 sel=None, keep=None):
    """Network eval + composite -> (rgb (B, 3) over bg, acc (B,), depth
    (B,)). Positions come from (o, d, t), so gradients reach the
    extrinsics offsets. `extra` (B, E) are each ray's latent codes;
    `exposure_scale` (B, 3) scales the ray's colour before the
    background composite (upstream's optimize_exposure). With sel/keep
    (compact_sample_sel) the network runs only on the `sel` samples; the
    others composite with zero alpha."""
    cfg = opts.config
    S, B = samples["dt"].shape
    n = S * B
    pos01 = _pos01(samples, o, d, aabb_min, aabb_max).reshape(n, 3)
    dir01 = ((d + 1.0) * 0.5)[None].expand(S, B, 3).reshape(n, 3)
    if extra is not None:
        extra = extra[None].expand((S,) + extra.shape).reshape(n, -1)
    valid = samples["valid"]
    if sel is not None:
        # row gathers whose backward (into the extrinsics offsets and the
        # latent codes) is an index_add
        rgb_c, sigma_c = net(pos01.index_select(0, sel),
                             dir01.index_select(0, sel), opts.cdtype,
                             opts.edtype,
                             extra=None if extra is None
                             else extra.index_select(0, sel))
        sigma_raw = torch.zeros((n,), device=o.device).index_copy(0, sel,
                                                                  sigma_c)
        rgb_raw = torch.zeros((n, 3), device=o.device).index_copy(0, sel,
                                                                  rgb_c)
        evaluated = torch.zeros((n,), dtype=torch.bool,
                                device=o.device).index_copy(
            0, sel, keep.reshape(-1)[sel])
        valid = valid & evaluated.reshape(S, B)
    else:
        rgb_raw, sigma_raw = net(pos01, dir01, opts.cdtype, opts.edtype,
                                 extra=extra)
    rgb = apply_rgb_activation(rgb_raw.reshape(S, B, 3), cfg.rgb_activation)
    sigma = apply_density_activation(sigma_raw.reshape(S, B),
                                     cfg.density_activation)
    alpha = torch.where(valid, 1.0 - torch.exp(-sigma * samples["dt"]), 0.0)
    w = alpha * _exclusive_cumprod(1.0 - alpha)                 # (S, B)
    rgb_ray = torch.sum(w[..., None] * rgb, dim=0)
    acc = torch.sum(w, dim=0)
    depth_ray = torch.sum(w * samples["t"], dim=0)
    if exposure_scale is not None:
        rgb_ray = rgb_ray * exposure_scale
    return rgb_ray + (1.0 - acc)[:, None] * bg, acc, depth_ray


def _loss_fn(pred, target, opts: TrainOptions):
    """tcnn's loss menu (L2, L1, relative L2, MAPE, SMAPE, log-L1,
    Huber), as the snapshot's loss config selects it."""
    diff = pred - target
    lt = opts.loss_type
    if lt == "l2":
        return torch.mean(diff * diff)
    if lt == "l1":
        return torch.mean(torch.abs(diff))
    if lt == "relative_l2":
        return torch.mean(diff * diff / (pred * pred + 1e-2))
    if lt == "mape":
        return torch.mean(torch.abs(diff) / (torch.abs(target) + 1e-2))
    if lt == "smape":
        return torch.mean(2.0 * torch.abs(diff)
                          / (torch.abs(target) + torch.abs(pred) + 1e-2))
    if lt == "log_l1":
        return torch.mean(torch.log(1.0 + torch.abs(diff)))
    if lt == "huber":
        return torch.mean(_huber(diff, opts.huber_delta))
    raise ValueError(lt)


def _huber(diff, delta: float):
    a = torch.abs(diff)
    return torch.where(a <= delta, 0.5 * diff * diff / delta, a - 0.5 * delta)


# ---------------------------------------------------------------------------
# Adam (tcnn hyperparameters)
# ---------------------------------------------------------------------------

def _learning_rate(step: int, opts: TrainOptions) -> np.float32:
    lr = np.float32(opts.learning_rate)
    if opts.lr_decay >= 1.0:
        return lr
    n = max(step - opts.lr_decay_start, 0) // opts.lr_decay_interval
    return lr * np.float32(opts.lr_decay) ** np.float32(n)


def _adam_corr(step: int, opts: TrainOptions) -> np.float32:
    """Adam's bias correction sqrt(1 - b2^t) / (1 - b1^t), t = step + 1,
    as an f32 host scalar (the step is known on the host)."""
    t = np.float32(step) + np.float32(1.0)
    return (np.sqrt(np.float32(1.0) - np.float32(opts.beta2) ** t)
            / (np.float32(1.0) - np.float32(opts.beta1) ** t))


def adam_lr(step: int, opts: TrainOptions) -> float:
    """The learning rate times Adam's bias correction at `step`, an f32
    value (both f32 host scalars)."""
    return float(np.float32(_learning_rate(step, opts)
                            * _adam_corr(step, opts)))


def lr_tensor(steps, opts: TrainOptions, device) -> torch.Tensor:
    """adam_lr of each step in `steps` -> (len,) f32 on `device`: on the
    card one copy from pinned memory, with no wait on the host."""
    vals = torch.tensor([adam_lr(s, opts) for s in steps],
                        dtype=torch.float32)
    if torch.device(device).type != "cuda":
        return vals.to(device)
    return vals.pin_memory().to(device, non_blocking=True)


def adam_update(net: NerfNetwork, grads, opt, step: int, opts: TrainOptions,
                lr_corr: torch.Tensor = None):
    """One Adam step on `net`'s parameters in place
    (ops/adam_cuda.adam: on the card one launch for all of them, on the
    CPU its plain version, the former aten update bit for bit). lr_corr:
    one f32 on the parameters' device holding adam_lr(step, opts), which
    the kernel reads when it runs; None makes it from `step`. The hash
    table takes no l2 regularisation."""
    names, params = zip(*net.named_parameters())
    if lr_corr is None:
        lr_corr = lr_tensor([step], opts, params[0].device)
    with torch.no_grad():
        adam_cuda.adam([p.detach() for p in params],
                       [grads[n] for n in names],
                       [opt["m"][n] for n in names],
                       [opt["v"][n] for n in names],
                       [0.0 if n == "grid" else opts.l2_reg for n in names],
                       lr_corr, opts.beta1, opts.beta2, opts.eps)


def _aux_lr(key: str, opts: TrainOptions) -> float:
    return {"cam_rot": opts.extrinsics_lr, "cam_trans": opts.extrinsics_lr,
            "distortion": opts.distortion_lr, "envmap": opts.envmap_lr,
            "extra_dims": opts.extra_dims_lr,
            "exposure": opts.exposure_lr}[key]


def _aux_adam_update(aux, grads, opt, step: int, opts: TrainOptions):
    """Adam for the auxiliary models, each with its own learning rate
    (upstream keeps one AdamOptimizer per model) -> (new aux, new moments).
    The extrinsics offsets take an L2 anchor toward zero (it removes the
    gauge freedom of scene and cameras drifting together); the exposures
    are re-centred to zero mean per channel after the step."""
    b1, b2 = opts.beta1, opts.beta2
    corr = _adam_corr(step, opts)
    new_aux, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for key, a in aux.items():
            g = grads[key]
            if key in ("cam_rot", "cam_trans"):
                g = g + opts.extrinsics_l2_reg * a
            m = b1 * opt["m"][key] + (1 - b1) * g
            v = b2 * opt["v"][key] + (1 - b2) * g * g
            lr_corr = float(np.float32(np.float32(_aux_lr(key, opts)) * corr))
            new = a - lr_corr * m / (torch.sqrt(v) + opts.eps)
            if key == "exposure":
                new = new - torch.mean(new, dim=0, keepdim=True)
            new_aux[key], new_m[key], new_v[key] = new, m, v
    return new_aux, {"m": new_m, "v": new_v}


# ---------------------------------------------------------------------------
# Train step and density grid
# ---------------------------------------------------------------------------

def _loss_and_grads(state, data, img, px, py, target, samples, bg,
                    opts: TrainOptions):
    """-> (loss, per_ray_err, grads {param name: tensor}, aux_grads {aux
    name: tensor}, n_keep or None). The network and the aux models are
    differentiated together. In envmap mode the background is the envmap
    at each ray's direction, and the target's composite takes it detached
    (else the envmap cancels out of the residual and never learns the
    true background). per_ray_err is the channel-mean squared residual
    feeding the error map."""
    sel = keep = n_keep = None
    if opts.compact_keep_fraction > 0.0:
        sel, keep, n_keep = compact_sample_sel(state, data, img, px, py,
                                               samples, opts)
    net = state["net"]
    aux = {k: a.detach().requires_grad_(True)
           for k, a in state["aux"].items()}
    o, d = _gen_rays(data, img, px, py, aux, opts.apply_lens_distortion)
    if opts.train_envmap:
        bg = _sample_envmap_dir(aux["envmap"], d)
        bg_t = bg.detach()
    else:
        bg_t = bg
    target_rgb = target[:, :3] + (1.0 - target[:, 3:4]) * bg_t
    extra = (aux["extra_dims"].index_select(0, img)
             if "extra_dims" in aux else None)
    exp_scale = (torch.exp(aux["exposure"].index_select(0, img))
                 if "exposure" in aux else None)
    pred, _, pdepth = forward_rays(net, samples, o, d, bg, opts,
                                   state["aabb_min"], state["aabb_max"],
                                   extra=extra, exposure_scale=exp_scale,
                                   sel=sel, keep=keep)
    diff = pred - target_rgb
    per_ray_err = torch.mean(diff * diff, dim=-1).detach()
    loss = _loss_fn(pred, target_rgb, opts)
    lam = opts.depth_supervision_lambda
    if lam != 0.0 and "depths" in data:
        lam = 1.0 if lam < 0.0 else lam
        td = data["depths"][img, py, px]
        dvalid = (td > 0.0).float()
        hub = _huber(pdepth - td, opts.huber_delta)
        loss = loss + lam * (torch.sum(hub * dvalid)
                             / torch.clamp(torch.sum(dvalid), min=1.0))
    names, params = zip(*net.named_parameters())
    keys = list(aux)
    grads = torch.autograd.grad(loss, list(params) + [aux[k] for k in keys])
    return (loss.detach(), per_ray_err,
            dict(zip(names, grads[:len(names)])),
            dict(zip(keys, grads[len(names):])), n_keep)


def _ray_batch(state, data, draws, n_rays: int, opts: TrainOptions):
    """Sample pixels (with the error map past its warmup), build their rays
    with the current aux models applied and detached, and march the
    geometry pass -> (img, px, py, target, samples). No gradient."""
    _check_batch(draws, n_rays)
    with torch.no_grad():
        img, px, py, target = _sample_pixels(draws, data,
                                             state.get("error_map"),
                                             state["step"], opts)
        o, d = _gen_rays(data, img, px, py, state["aux"],
                         opts.apply_lens_distortion)
        samples = march_training_samples(
            state["occ"], o, d, draws["u"], opts, state["aabb_min"],
            state["aabb_max"], opts.config.max_cascade)
    return img, px, py, target, samples


def _mean_over_ranks(mesh, loss, grads, aux_grads):
    """Loss, gradients and aux gradients averaged over the mesh's ranks in
    one all-reduce: each rank's loss is a mean over its own rays, so the
    mean of the means is the global mean."""
    names, keys = list(grads), list(aux_grads)
    out = mesh.reduce([loss] + [grads[k] for k in names]
                      + [aux_grads[k] for k in keys], mean=True)
    return (out[0], dict(zip(names, out[1:1 + len(names)])),
            dict(zip(keys, out[1 + len(names):])))


def _train_step_body(state, data, opts: TrainOptions, draws, mesh=None,
                     lr_corr: torch.Tensor = None):
    """One training step from its draws (draw_step); updates `state` in
    place and returns the loss, a 0-d device tensor. Every tensor of the
    state keeps its storage (its values are written in place), so that a
    captured step reads and writes the same tensors at each replay; only
    "aux", "aux_opt" and "step" are rebound. lr_corr: adam_update's. The
    background is the random draw when random_bg and no envmap trains,
    else white (an envmap step draws it all the same, so the draws match
    the JAX package's).

    With `mesh` (parallel.sharding.Mesh) every rank runs this step on its
    own draws of opts.rays_per_batch rays, from the same replicated
    state: loss, gradients and aux gradients are averaged over the ranks,
    the error map's (sum, count) rasters and the keep-set overflow counts
    summed, so that every rank applies the same update
    (nerf_glasses_tpu/parallel/sharding.py:278-333)."""
    step = state["step"]
    B = opts.rays_per_batch
    img, px, py, target, samples = _ray_batch(state, data, draws, B, opts)
    bg = (draws["bg"] if opts.random_bg and not opts.train_envmap
          else torch.ones((B, 3), device=target.device))
    loss, per_ray_err, grads, aux_grads, n_keep = _loss_and_grads(
        state, data, img, px, py, target, samples, bg, opts)
    with torch.no_grad():
        if mesh is not None:
            loss, grads, aux_grads = _mean_over_ranks(mesh, loss, grads,
                                                      aux_grads)
        adam_update(state["net"], grads, state["opt"], step, opts, lr_corr)
        state["aux"], state["aux_opt"] = _aux_adam_update(
            state["aux"], aux_grads, state["aux_opt"], step, opts)
        state["loss_ema"].copy_(loss if step == 0
                                else 0.99 * state["loss_ema"] + 0.01 * loss)
        if n_keep is not None:
            bucket = compact_bucket(B * opts.samples_per_ray,
                                    opts.compact_keep_fraction)
            over = n_keep - bucket
            counts = [(over > 0).long(), torch.clamp(over, min=0)]
            if mesh is not None:
                counts = mesh.reduce(counts)
            state["overflow_steps"] += counts[0]
            state["overflow_samples"] += counts[1]
        if "error_map" in state:
            h, w = data["images"].shape[1:3]
            sum_g, cnt_g = _error_map_accum(state["error_map"], img, px, py,
                                            per_ray_err, w, h)
            if mesh is not None:
                # never apply a raster local to one rank: index_put_'s
                # accumulation order differs between ranks on the card
                sum_g, cnt_g = mesh.reduce([sum_g, cnt_g])
            state["error_map"].copy_(_error_map_apply(
                state["error_map"], sum_g, cnt_g, opts.error_map_beta))
    state["step"] = step + 1
    return loss


def train_step(state, data, opts: TrainOptions, draws, mesh=None):
    """One training step from its draws (draw_step) -> (state, loss 0-d
    tensor); `state` is updated in place. `mesh`: see _train_step_body."""
    return state, _train_step_body(state, data, opts, draws, mesh)


def update_density_grid(state, opts: TrainOptions, draws,
                        rebuild_occ: bool = True):
    """The density-grid refresh from its draws (draw_grid_update) ->
    state, its grid and occupancy written in place."""
    _update_density_grid_body(state, opts, draws, rebuild_occ)
    return state


def train_chunk(state, data, opts: TrainOptions, n_steps: int,
                update_grid: bool, rebuild_occ: bool, draws_fn, mesh=None):
    """The grid refresh when `update_grid`, then n_steps training steps ->
    (state, losses (n_steps,) on the device); no host read.
    draws_fn(kind, opts) returns the draws of the refresh (kind "grid",
    draw_grid_update) and of each step (kind "step", draw_step), in the
    order they run. With `mesh` the refresh is replicated: every rank
    must draw it alike."""
    if update_grid:
        update_density_grid(state, opts, draws_fn("grid", opts), rebuild_occ)
    lrs = lr_tensor(range(state["step"], state["step"] + n_steps), opts,
                    data["images"].device)
    losses = [_train_step_body(state, data, opts, draws_fn("step", opts),
                               mesh, lrs[i:i + 1]) for i in range(n_steps)]
    return state, torch.stack(losses)


def _update_density_grid_body(state, opts: TrainOptions, draws,
                              rebuild_occ: bool = True):
    """EMA decay + scatter-max of the live network's optical thickness
    (sigma * MIN_CONE_STEPSIZE, the scale NERF_MIN_OPTICAL_THICKNESS
    thresholds) at the drawn cells, then the occupancy rebuild; during
    warmup (`rebuild_occ` False) the occupancy stays all on. The density
    query uses the training encode dtype (`opts.edtype`, bf16 by
    default), as the JAX package's refresh does. Updates `state`."""
    cfg = opts.config
    casc, cell, jitter = draws["casc"], draws["cell"], draws["jitter"]
    with torch.no_grad():
        half = torch.exp2(casc.float())[:, None] * 0.5
        pos = ((cell + jitter) / G - 0.5) * (2.0 * half) + 0.5
        extent = state["aabb_max"] - state["aabb_min"]
        pos01 = torch.clamp((pos - state["aabb_min"]) / extent, 0.0, 1.0)
        raw = state["net"].density_raw(pos01, opts.cdtype, opts.edtype)[:, 0]
        sigma = apply_density_activation(raw, cfg.density_activation)
        grid = state["density_grid"] * opts.density_grid_decay
        flat_idx = ((casc * G + cell[:, 2]) * G + cell[:, 1]) * G + cell[:, 0]
        grid = grid.reshape(-1).scatter_reduce(
            0, flat_idx, sigma * C.MIN_CONE_STEPSIZE, reduce="amax"
        ).reshape(grid.shape)
        state["density_grid"].copy_(grid)
        if rebuild_occ:
            state["occ"].copy_(occ_ops.build_occupancy(grid, cfg.max_cascade))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

# the modules whose wrappers a training step launches; a replay of the
# settled step adds the launches its capture held to their counts
_COUNTED = (march_cuda, network_cuda, adam_cuda)


class Trainer:
    """Trainer(dataset).train_until(...) -> save_snapshot(path). All
    tensors live on `device`; nothing moves to the host per step."""

    # upstream keeps the grid dense for its first 256 training steps
    occ_warmup_steps: int = 256
    # loss-graph buffer parity (testbed.cuh:561)
    loss_history_capacity: int = 256
    # re-check the adaptive compaction gate at this step cadence (one
    # scalar host read per check)
    compact_check_interval: int = 256
    # captured steps kept at once, the least recent dropped
    max_graphs: int = 4

    def __init__(self, dataset: NerfDataset, opts: TrainOptions = None,
                 seed: int = 1337, device="cuda"):
        if opts is None:
            opts = TrainOptions(config=NGPConfig.from_snapshot_config(
                {}, dataset.aabb_scale, dataset.is_hdr))
        if dataset_has_distortion(dataset) and not opts.apply_lens_distortion:
            opts = dataclasses.replace(opts, apply_lens_distortion=True)
        self.opts = opts
        self.dataset = dataset
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.data = prepare_dataset_arrays(dataset, self.device)
        half = 0.5 * min(1 << (C.NERF_CASCADES - 1), dataset.aabb_scale)
        self.aabb_min = np.full(3, 0.5 - half, np.float32)
        self.aabb_max = np.full(3, 0.5 + half, np.float32)
        self.state = make_train_state(opts, self.aabb_min, self.aabb_max,
                                      dataset.n_images, self.gen, self.device)
        self.loss = float("nan")
        self.loss_history = []
        self._host_step = 0
        # the adaptive compaction gate: compaction stays off during the
        # occupancy warmup and until the occupied fraction falls under
        # compact_occ_frac_gate, then stays on
        self._dense_opts = (dataclasses.replace(opts, compact_keep_fraction=0.0)
                            if opts.compact_keep_fraction > 0.0 else opts)
        self._compact_ready = False
        self._last_compact_check = -(1 << 30)
        # the settled step's graph (train): on where True
        self.graphs = True
        # graph_key -> (the captured step, its loss tensor)
        self._graphs: Dict[tuple, tuple] = {}
        self._warm_key = None
        self._static = None         # the graph's draws and lr_corr
        self._side = None           # the stream graphs warm up and capture on
        # steps run eagerly and steps replayed since construction
        self.eager_steps = 0
        self.replayed_steps = 0

    @property
    def step(self) -> int:
        return self._host_step

    @property
    def net(self) -> NerfNetwork:
        return self.state["net"]

    @property
    def keep_overflow(self):
        """(compacted steps whose keep set exceeded the bucket, kept
        samples those steps dropped); one host read."""
        return (int(self.state["overflow_steps"]),
                int(self.state["overflow_samples"]))

    def _compaction_active(self, step: int) -> bool:
        o = self.opts
        if o.compact_keep_fraction <= 0.0 or step < self.occ_warmup_steps:
            return False
        if self._compact_ready:
            return True
        if step - self._last_compact_check >= self.compact_check_interval:
            self._last_compact_check = step
            n_casc = o.config.max_cascade + 1
            frac = float((self.state["occ"][:n_casc] > 0).float().mean())
            if frac <= o.compact_occ_frac_gate:
                self._compact_ready = True
        return self._compact_ready

    def _chunk_opts(self, step: int) -> TrainOptions:
        if (self.opts.compact_keep_fraction > 0.0
                and not self._compaction_active(step)):
            return self._dense_opts
        return self.opts

    def _draws(self, kind: str, opts: TrainOptions):
        """The draws of a grid refresh (kind "grid") or of a step (kind
        "step"), from the trainer's generator."""
        if kind == "grid":
            return draw_grid_update(self.gen, opts.grid_samples_per_update,
                                    opts.config.max_cascade + 1, self.device)
        return draw_step(self.gen, self.state, self.data, opts)

    def _fns_for(self, step: int):
        """(chunk_fn, step_fn) for the chunk that starts at `step`, on the
        options of _chunk_opts: chunk_fn(state, data, n_steps,
        update_grid, rebuild_occ, draws_fn) -> (state, losses) and
        step_fn(state, data, draws_fn) -> (state, loss), on this
        trainer's state, data and draws (_chunk)."""
        o = self._chunk_opts(step)

        def chunk_fn(state, data, n_steps, update_grid, rebuild_occ,
                     draws_fn):
            return state, self._chunk(o, n_steps, update_grid, rebuild_occ)

        def step_fn(state, data, draws_fn):
            return state, self._chunk(o, 1, False, False)[0]

        return chunk_fn, step_fn

    def takes_graph(self) -> bool:
        """The rule for a replayed step: graphs on, the card, no aux model
        training, past step 0 (whose loss EMA takes the first loss)."""
        return (self.graphs and self.device.type == "cuda"
                and not self.state["aux"] and self.state["step"] > 0)

    def _chunk(self, o: TrainOptions, n: int, update_grid: bool,
               rebuild_occ: bool) -> torch.Tensor:
        """The grid refresh when `update_grid`, then n steps on options o,
        each replayed (_graph_step) where takes_graph() holds, else eager
        -> losses (n,) on the device. The chunk's learning rates go to the
        device in one copy."""
        st = self.state
        if update_grid:
            update_density_grid(st, o, self._draws("grid", o), rebuild_occ)
        lrs = lr_tensor(range(st["step"], st["step"] + n), o, self.device)
        losses = torch.empty((n,), device=self.device)
        for i in range(n):
            if self.takes_graph():
                loss = self._graph_step(o, lrs[i:i + 1])
            else:
                loss = _train_step_body(st, self.data, o,
                                        self._draws("step", o),
                                        lr_corr=lrs[i:i + 1])
                self.eager_steps += 1
            losses[i].copy_(loss)
        return losses

    def graph_key(self, o: TrainOptions) -> tuple:
        """What a captured step bakes in: the options (the compaction gate
        picks them), the error map's branch (warmup or inverse CDF), and
        the address, shape and type of every tensor of the state and the
        data that the step reads or writes."""
        st = self.state
        tensors = ([p for _, p in st["net"].named_parameters()]
                   + [t for k in ("m", "v") for t in st["opt"][k].values()]
                   + [st[k] for k in ("density_grid", "occ", "aabb_min",
                                      "aabb_max", "loss_ema", "overflow_steps",
                                      "overflow_samples", "error_map")
                      if k in st]
                   + [self.data[k] for k in sorted(self.data)])
        past_warmup = "error_map" in st and st["step"] >= o.error_map_warmup
        return (o, past_warmup, tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                                      for t in tensors))

    def _graph_step(self, o: TrainOptions, lr: torch.Tensor) -> torch.Tensor:
        """One step through the graph of its key (graph_key): the draws in
        place into the graph's buffers and lr_corr copied to its slot, then
        one replay -> the graph's loss tensor (the next replay overwrites
        it). A key's first step runs eagerly on the buffers and the
        capture stream (it warms the kernels and the stream's library
        handles up); its second is captured (raymarch.capture_graph) and
        replayed."""
        st = self.state
        if self._static is None:
            self._static = {"draws": step_draw_buffers(self.data, o,
                                                       "error_map" in st),
                            "lr": torch.empty((1,), device=self.device)}
            self._side = torch.cuda.Stream(self.device)
        draws, slot = self._static["draws"], self._static["lr"]
        draw_step_into(self.gen, draws, self.data)
        slot.copy_(lr)
        key = self.graph_key(o)
        g = self._graphs.pop(key, None)
        if g is None and self._warm_key != key:
            self._warm_key = key
            main = torch.cuda.current_stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                loss = _train_step_body(st, self.data, o, draws, lr_corr=slot)
            main.wait_stream(self._side)
            self.eager_steps += 1
            return loss
        if g is None:
            # the step body sees a copy of the dict, so that the capture
            # advances no step count (the tensors are the state's)
            g = raymarch.capture_graph(
                lambda: _train_step_body(dict(st), self.data, o, draws,
                                         lr_corr=slot),
                self._side, _COUNTED, "the training step")
        self._graphs[key] = g               # the most recent last
        while len(self._graphs) > self.max_graphs:
            self._graphs.pop(next(iter(self._graphs)))
        graph, loss = g
        graph.replay()
        st["step"] += 1
        self.replayed_steps += 1
        return loss

    def drop_graphs(self):
        """Forget the captured steps (their memory is freed)."""
        self._graphs.clear()
        self._warm_key = None

    def update_density_grid(self, rebuild_occ: bool = True):
        update_density_grid(self.state, self.opts,
                            self._draws("grid", self.opts), rebuild_occ)

    def train_step(self, opts: Optional[TrainOptions] = None) -> torch.Tensor:
        opts = opts or self.opts
        return train_step(self.state, self.data, opts,
                          self._draws("step", opts))[1]

    def train(self, n_steps: int = 1, callback=None) -> float:
        """Advance n_steps, the density grid refreshed at the start of
        every grid_update_interval-aligned chunk (_fns_for). Losses
        stay on the device and come back in one fetch at the end; a
        `callback(step, loss)` reads each step's loss (one host read per
        step).

        On the card a step replays a captured CUDA graph where
        takes_graph() holds: `graphs` on, no aux model training, past
        step 0 (data-parallel steps, ShardedTrainer, run eagerly). The
        graph is cached by graph_key (the options, the error map's branch,
        the address of every tensor it reads: a new network or grid
        tensor makes a new graph); a key's first step runs eagerly, its
        second is captured. A replay reads its draws and the step's
        lr_corr from buffers of its own, which the host fills first (the
        draws in place from the trainer's generator, as draw_step draws
        them; one copy), and each step's loss is copied out of the
        graph. The grid refresh runs eagerly between replays and writes
        the grid and the occupancy in place. Every other step runs
        eagerly on the same kernels. A capture that fails raises."""
        interval = self.opts.grid_update_interval
        losses = []
        remaining = n_steps
        while remaining > 0:
            step = self._host_step
            update = step % interval == 0
            rebuild = step >= self.occ_warmup_steps
            n = min(interval - step % interval, remaining)
            chunk_fn, step_fn = self._fns_for(step)
            if callback is None:
                losses.append(chunk_fn(self.state, self.data, n, update,
                                       rebuild, self._draws)[1])
            else:
                if update:
                    self.update_density_grid(rebuild_occ=rebuild)
                for i in range(n):
                    loss = step_fn(self.state, self.data, self._draws)[1]
                    losses.append(loss[None])
                    callback(step + i + 1, float(loss))
            self._host_step += n
            remaining -= n
        if losses:
            all_losses = torch.cat(losses).cpu().numpy()
            self.loss = float(all_losses[-1])
            self.loss_history.extend(float(v) for v in all_losses)
            del self.loss_history[:-self.loss_history_capacity]
        return self.loss

    def train_until(self, target_loss: float = 0.00175,
                    max_steps: int = 10000, log_every: int = 100) -> float:
        """The reference train.py stop criteria (volume/train.py:11-12):
        the loss EMA under target_loss after step 100, or max_steps. The
        EMA is read once per grid-update chunk."""
        interval = self.opts.grid_update_interval
        while self.step < max_steps:
            self.train(min(interval, max_steps - self.step))
            ema = float(self.state["loss_ema"])
            if log_every and (self.step % log_every < interval):
                print(f"step {self.step}: loss {self.loss:.6f} "
                      f"(ema {ema:.6f})")
            if ema < target_loss and self.step > 100:
                break
        return self.loss

    def optimized_xforms(self) -> np.ndarray:
        """The dataset's camera matrices (n, 3, 4) with the trained
        per-image extrinsics offsets applied (d' = R(rot_i) R_i dirs, o' =
        o_i + trans_i): the refined cameras upstream's camera optimizer
        converges to."""
        xf = np.array(self.dataset.xforms, np.float32).copy()
        aux = self.state["aux"]
        if "cam_rot" not in aux:
            return xf
        rot = aux["cam_rot"].cpu().numpy()
        trans = aux["cam_trans"].cpu().numpy()
        for i in range(len(xf)):
            theta = float(np.linalg.norm(rot[i]))
            if theta > 1e-12:
                k = rot[i] / theta
                K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                              [-k[1], k[0], 0]], np.float32)
                R = (np.eye(3, dtype=np.float32) + np.sin(theta) * K
                     + (1 - np.cos(theta)) * (K @ K))
                xf[i, :, :3] = R @ xf[i, :, :3]
            xf[i, :, 3] += trans[i]
        return xf

    def to_testbed(self):
        """A Testbed holding a copy of the current network (gradients
        off), the density grid and the dataset's metadata; with latent
        codes the first training view's as the inference codes
        (get_inference_extra_dims' default, testbed.cu:1614-1631), with a
        trained distortion raster the Testbed's distortion_map (rendered
        when nerf.render_with_lens_distortion is set)."""
        from nerf_glasses_tpu_torch.models.testbed import Testbed
        tb = Testbed(device=self.device)
        tb.config = self.opts.config
        tb.net = self.net.detached_copy()
        tb.density_grid = self.state["density_grid"].cpu().numpy()
        tb.dataset = self.dataset
        tb.aabb = BoundingBox(self.aabb_min, self.aabb_max)
        tb.raw_aabb = tb.aabb.copy()
        tb.render_aabb = tb.aabb.copy()
        if not self.dataset.render_aabb.is_empty():
            tb.render_aabb = self.dataset.render_aabb.intersection(tb.aabb)
        tb.render_aabb_to_local = self.dataset.render_aabb_to_local.copy()
        tb.training_step = self.step
        tb.loss = self.loss
        aux = self.state["aux"]
        if "extra_dims" in aux:
            tb.extra_dims = aux["extra_dims"][0].cpu().numpy()
        if "distortion" in aux:
            tb.distortion_map = aux["distortion"].cpu().numpy()
        tb._cone_angle = self.opts.config.cone_angle_constant
        tb.update_occupancy()
        return tb

    def save_snapshot(self, path: str):
        self.to_testbed().save_snapshot(path)

    def load_snapshot(self, path: str):
        """Resume from a snapshot: params, the density grid (and its
        rebuilt occupancy), the step, the loss and the latent codes (the
        snapshot's (E,) inference code goes to every image); Adam moments
        restart at zero (the format carries params only). The snapshot's
        network config must equal the Trainer's."""
        from nerf_glasses_tpu_torch.io import snapshot as snap_io
        from nerf_glasses_tpu_torch.ops.network import unpack_params
        s = snap_io.load_snapshot(path)
        if s.config != self.opts.config:
            raise ValueError(
                f"snapshot config {s.config} != Trainer config "
                f"{self.opts.config}; build the Trainer with the snapshot's "
                f"config to resume")
        net = unpack_params(s.params_blob, s.config,
                            self.device).requires_grad_(True)
        st = self.state
        self.drop_graphs()
        st["net"] = net
        st["opt"] = adam_init(net)
        n_casc = self.opts.config.max_cascade + 1
        grid = torch.as_tensor(np.asarray(s.density_grid, np.float32)[:n_casc],
                               device=self.device)
        st["density_grid"] = grid
        st["occ"] = occ_ops.build_occupancy(grid, self.opts.config.max_cascade)
        st["step"] = int(s.training_step)
        st["loss_ema"] = torch.tensor(float(s.loss or 0.0), device=self.device)
        if s.extra_dims is not None and "extra_dims" in st["aux"]:
            ed = torch.as_tensor(np.asarray(s.extra_dims, np.float32),
                                 device=self.device)
            if ed.ndim == 1:
                ed = ed.expand_as(st["aux"]["extra_dims"])
            if ed.shape == st["aux"]["extra_dims"].shape:
                st["aux"] = {**st["aux"], "extra_dims": ed.clone()}
        self._host_step = int(s.training_step)
        self.loss = float(s.loss or float("nan"))
        self._compact_ready = False
        self._last_compact_check = -(1 << 30)

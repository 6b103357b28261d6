"""NeRF dataset: coordinate conventions, the snapshot's dataset section
and transforms.json loading.

Port of nerf_glasses_tpu/io/dataset.py (reference nerf_loader.cuh:67-182
for the conversions, json_binding.h:133-204 for the json section, and
upstream instant-ngp's transforms.json loader, nerf_loader.cu:300-856).
numpy and PIL only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox


# ---------------------------------------------------------------------------
# Coordinate conventions (nerf_loader.cuh:105-181)
# ---------------------------------------------------------------------------

def nerf_matrix_to_ngp(m: np.ndarray, scale: float, offset: np.ndarray,
                       from_mitsuba: bool = False,
                       scale_columns: bool = False) -> np.ndarray:
    """3x4 camera-to-world, nerf (dataset) space -> NGP unit-cube space."""
    r = np.array(m, np.float32, copy=True)
    r[:, 0] *= scale if scale_columns else 1.0
    r[:, 1] *= -scale if scale_columns else -1.0
    r[:, 2] *= -scale if scale_columns else -1.0
    r[:, 3] = r[:, 3] * scale + offset
    if from_mitsuba:
        r[:, 0] *= -1
        r[:, 2] *= -1
    else:
        r = r[[1, 2, 0], :]  # cycle rows xyz <- yzx
    return r


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray,
                       from_mitsuba: bool = False,
                       scale_columns: bool = False) -> np.ndarray:
    r = np.array(m, np.float32, copy=True)
    if from_mitsuba:
        r[:, 0] *= -1
        r[:, 2] *= -1
    else:
        r = r[[2, 0, 1], :]  # cycle rows xyz -> yzx
    r[:, 0] *= (1.0 / scale) if scale_columns else 1.0
    r[:, 1] *= (-1.0 / scale) if scale_columns else -1.0
    r[:, 2] *= (-1.0 / scale) if scale_columns else -1.0
    r[:, 3] = (r[:, 3] - offset) / scale
    return r


def nerf_position_to_ngp(pos: np.ndarray, scale: float, offset: np.ndarray,
                         from_mitsuba: bool = False) -> np.ndarray:
    rv = np.asarray(pos, np.float32) * scale + offset
    return rv if from_mitsuba else rv[[1, 2, 0]]


def ngp_position_to_nerf(pos: np.ndarray, scale: float, offset: np.ndarray,
                         from_mitsuba: bool = False) -> np.ndarray:
    p = np.asarray(pos, np.float32)
    if not from_mitsuba:
        p = p[[2, 0, 1]]
    return (p - offset) / scale


def nerf_direction_to_ngp(d: np.ndarray, from_mitsuba: bool = False):
    """(nerf_loader.cuh:105-113)"""
    d = np.asarray(d, np.float32)
    return -d if from_mitsuba else d[[1, 2, 0]]


def nerf_ray_to_ngp(o, d, scale: float, offset, scale_direction=False):
    """(nerf_loader.cuh:167-181)"""
    o = np.asarray(o, np.float32) * scale + np.asarray(offset, np.float32)
    d = np.asarray(d, np.float32) * (scale if scale_direction else 1.0)
    return o[[1, 2, 0]], d[[1, 2, 0]]


# ---------------------------------------------------------------------------
# Dataset container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ImageMetadata:
    resolution: Tuple[int, int] = (0, 0)
    focal_length: Tuple[float, float] = (1000.0, 1000.0)
    principal_point: Tuple[float, float] = (0.5, 0.5)
    rolling_shutter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    lens_mode: str = "perspective"
    lens_params: Tuple[float, ...] = (0.0,) * 7
    light_dir: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class NerfDataset:
    """Camera metadata (and optionally pixels) in NGP space."""
    xforms: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 4), np.float32))
    xforms_end: Optional[np.ndarray] = None
    metadata: List[ImageMetadata] = dataclasses.field(default_factory=list)
    paths: List[str] = dataclasses.field(default_factory=list)
    render_aabb: BoundingBox = dataclasses.field(default_factory=BoundingBox)
    render_aabb_to_local: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    n_images: int = 0
    envmap_resolution: Tuple[int, int] = (0, 0)
    scale: float = 1.0
    aabb_scale: int = 1
    from_mitsuba: bool = False
    is_hdr: bool = False
    wants_importance_sampling: bool = True
    n_extra_learnable_dims: int = 0
    has_light_dirs: bool = False
    # training pixels: (H, W, 4) float32 linear premultiplied per image
    images: Optional[List[np.ndarray]] = None
    # per-image (H, W) float32 depth in NGP units (0 = no supervision),
    # or None for an image without depth (nerf_loader.cu:756-856)
    depth_images: Optional[List[Optional[np.ndarray]]] = None

    @property
    def n_extra_dims(self) -> int:
        return (3 if self.has_light_dirs else 0) + self.n_extra_learnable_dims


def create_empty_nerf_dataset(n_images: int, aabb_scale: int = 1,
                              is_hdr: bool = False) -> NerfDataset:
    """(nerf_loader.cu create_empty_nerf_dataset): a dataset shell whose
    images and cameras are filled by set_training_image /
    set_camera_extrinsics."""
    ds = NerfDataset()
    ds.n_images = n_images
    ds.aabb_scale = aabb_scale
    ds.is_hdr = is_hdr
    ds.scale = C.NERF_SCALE
    ds.offset = np.array([0.5, 0.5, 0.5], np.float32)
    ds.metadata = [ImageMetadata() for _ in range(n_images)]
    ds.paths = [""] * n_images
    ds.xforms = np.tile(np.eye(3, 4, dtype=np.float32), (n_images, 1, 1))
    ds.xforms_end = ds.xforms.copy()
    ds.images = [None] * n_images
    ds.render_aabb = BoundingBox([0, 0, 0], [1, 1, 1])
    return ds


# ---------------------------------------------------------------------------
# json (the snapshot's "dataset" section) <-> NerfDataset
# ---------------------------------------------------------------------------

def dataset_from_json(j: dict) -> NerfDataset:
    ds = NerfDataset()
    ds.n_images = int(j["n_images"])
    ds.paths = list(j.get("paths", [""] * ds.n_images))
    ds.metadata = [ImageMetadata() for _ in range(ds.n_images)]
    xforms = np.zeros((ds.n_images, 3, 4), np.float32)
    xforms_end = np.zeros((ds.n_images, 3, 4), np.float32)
    for i in range(ds.n_images):
        xf = j["xforms"][i]
        xforms[i] = np.asarray(xf["start"], np.float32)
        xforms_end[i] = np.asarray(xf["end"], np.float32)
        md = ds.metadata[i]
        if "metadata" in j:
            ji = j["metadata"][i]
            md.resolution = tuple(int(v) for v in ji["resolution"])
            md.focal_length = tuple(float(v) for v in ji["focal_length"])
            md.principal_point = tuple(float(v) for v in ji["principal_point"])
            lens = ji.get("lens", ji.get("camera_distortion", {}))
            md.lens_mode, md.lens_params = _lens_from_json(lens)
    ds.xforms = xforms
    ds.xforms_end = xforms_end
    ds.render_aabb = BoundingBox(np.asarray(j["render_aabb"]["min"], np.float32),
                                 np.asarray(j["render_aabb"]["max"], np.float32))
    if "render_aabb_to_local" in j:
        ds.render_aabb_to_local = np.asarray(j["render_aabb_to_local"],
                                             np.float32)
    ds.up = np.asarray(j["up"], np.float32)
    ds.offset = np.asarray(j["offset"], np.float32)
    ds.envmap_resolution = tuple(int(v) for v in j["envmap_resolution"])
    ds.scale = float(j["scale"])
    ds.aabb_scale = int(j["aabb_scale"])
    ds.from_mitsuba = bool(j["from_mitsuba"])
    ds.is_hdr = bool(j.get("is_hdr", False))
    ds.wants_importance_sampling = bool(j.get("wants_importance_sampling", True))
    return ds


def dataset_to_json(ds: NerfDataset) -> dict:
    j = {
        "n_images": ds.n_images,
        "paths": list(ds.paths),
        "metadata": [],
        "xforms": [],
        "render_aabb": {"min": ds.render_aabb.min.tolist(),
                        "max": ds.render_aabb.max.tolist()},
        "render_aabb_to_local": ds.render_aabb_to_local.tolist(),
        "up": ds.up.tolist(),
        "offset": ds.offset.tolist(),
        "envmap_resolution": list(ds.envmap_resolution),
        "scale": float(ds.scale),
        "aabb_scale": int(ds.aabb_scale),
        "from_mitsuba": bool(ds.from_mitsuba),
        "is_hdr": bool(ds.is_hdr),
        "wants_importance_sampling": bool(ds.wants_importance_sampling),
    }
    xe = ds.xforms_end if ds.xforms_end is not None else ds.xforms
    for i in range(ds.n_images):
        md = ds.metadata[i]
        j["metadata"].append({
            "focal_length": list(md.focal_length),
            "lens": _lens_to_json(md.lens_mode, md.lens_params),
            "principal_point": list(md.principal_point),
            "rolling_shutter": list(md.rolling_shutter),
            "resolution": list(md.resolution),
        })
        j["xforms"].append({"start": ds.xforms[i].tolist(),
                            "end": xe[i].tolist()})
    return j


def _lens_from_json(j: dict) -> Tuple[str, Tuple[float, ...]]:
    p = [0.0] * 7
    if "k1" in j:
        p[0], p[1], p[2], p[3] = j["k1"], j["k2"], j["p1"], j["p2"]
        return "opencv", tuple(p)
    if "ftheta_p0" in j:
        for i in range(5):
            p[i] = j[f"ftheta_p{i}"]
        p[5], p[6] = j["w"], j["h"]
        return "ftheta", tuple(p)
    return "perspective", tuple(p)


def _lens_to_json(mode: str, params) -> dict:
    if mode == "opencv":
        return {"k1": params[0], "k2": params[1], "p1": params[2],
                "p2": params[3]}
    if mode == "ftheta":
        out = {f"ftheta_p{i}": params[i] for i in range(5)}
        out["w"], out["h"] = params[5], params[6]
        return out
    return {}


# ---------------------------------------------------------------------------
# transforms.json loader (upstream instant-ngp compatible)
# ---------------------------------------------------------------------------

def load_transforms_json(path: str, load_images: bool = True) -> NerfDataset:
    """Load a COLMAP-style transforms.json (and its images) into NGP
    space: camera_angle_x/y or fl_x/fl_y, cx/cy, w/h (global or per
    frame), k1/k2/p1/p2, aabb_scale, scale, offset, sharpen, and
    frames[].{file_path, transform_matrix, depth_path} with
    integer_depth_scale."""
    if os.path.isdir(path):
        path = os.path.join(path, "transforms.json")
    with open(path) as f:
        j = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    ds = NerfDataset()
    ds.aabb_scale = int(j.get("aabb_scale", 1))
    ds.scale = float(j.get("scale", C.NERF_SCALE))
    ds.offset = np.asarray(j.get("offset", [0.5, 0.5, 0.5]), np.float32)
    ds.from_mitsuba = bool(j.get("from_mitsuba", False))
    ds.is_hdr = bool(j.get("is_hdr", False))
    frames = j["frames"]
    ds.n_images = len(frames)
    w = float(j.get("w", 0)) or None
    h = float(j.get("h", 0)) or None

    def focal(frame):
        fw = frame.get("w", w)
        fh = frame.get("h", h)
        src = {**j, **frame}
        if "fl_x" in src:
            fx = float(src["fl_x"])
            fy = float(src.get("fl_y", fx))
        elif "camera_angle_x" in src:
            fx = 0.5 * fw / math.tan(0.5 * float(src["camera_angle_x"]))
            if "camera_angle_y" in src:
                fy = 0.5 * fh / math.tan(0.5 * float(src["camera_angle_y"]))
            else:
                fy = fx
        else:
            raise ValueError("transforms.json: no focal length information")
        return fx, fy, fw, fh

    xforms = np.zeros((ds.n_images, 3, 4), np.float32)
    ds.metadata = []
    ds.paths = []
    # depth supervision inputs (nerf_loader.cu:420-438, 487-488, 631-640):
    # 16-bit PNGs, stored in NGP units = raw * integer_depth_scale * scale
    enable_depth = bool(j.get("enable_depth_loading", True))
    int_depth_scale = float(j.get("integer_depth_scale", -1.0))
    depth_paths = []
    for i, frame in enumerate(frames):
        m = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
        xforms[i] = nerf_matrix_to_ngp(m, ds.scale, ds.offset, ds.from_mitsuba)
        img_path = os.path.join(base, frame["file_path"])
        if load_images and not os.path.splitext(img_path)[1]:
            for ext in (".png", ".jpg", ".jpeg"):
                if os.path.exists(img_path + ext):
                    img_path += ext
                    break
        ds.paths.append(img_path)
        fx, fy, fw, fh = focal(frame)
        src = {**j, **frame}
        cx = float(src.get("cx", 0.5 * fw)) / fw
        cy = float(src.get("cy", 0.5 * fh)) / fh
        md = ImageMetadata(resolution=(int(fw), int(fh)),
                           focal_length=(fx, fy), principal_point=(cx, cy))
        if "k1" in src:
            md.lens_mode = "opencv"
            md.lens_params = (float(src.get("k1", 0)), float(src.get("k2", 0)),
                              float(src.get("p1", 0)), float(src.get("p2", 0)),
                              0.0, 0.0, 0.0)
        ds.metadata.append(md)
        dp = frame.get("depth_path")
        depth_paths.append(os.path.join(base, dp) if dp else None)
    ds.xforms = xforms
    ds.xforms_end = xforms.copy()
    if (load_images and enable_depth and int_depth_scale > 0.0
            and any(depth_paths)):
        from PIL import Image
        depths = []
        for dp in depth_paths:
            if dp is None or not os.path.exists(dp):
                depths.append(None)
                continue
            raw = np.asarray(Image.open(dp), np.float32)
            if raw.ndim == 3:
                raw = raw[..., 0]
            depths.append(raw * int_depth_scale * ds.scale)
        ds.depth_images = depths
    images = None
    if load_images:
        with ThreadPoolExecutor(max_workers=8) as pool:
            images = list(pool.map(load_training_image, ds.paths))
        # dataset-level sharpening (nerf_loader.cu:459-460)
        sharpen = float(j.get("sharpen", 0.0))
        if sharpen > 0.0:
            images = [sharpen_image(im, sharpen) for im in images]
    ds.images = images
    return ds


def sharpen_image(img: np.ndarray, amount: float) -> np.ndarray:
    """Unsharp mask of a (H, W, 4) training image (nerf_loader.cu:101-121,
    811-833):

        out = max(0, (center_w * p - p_left - p_up - p_right - p_down)
                     / (center_w - 4)),  center_w = 4 + 1/amount

    Neighbours are indexed flat, as in the reference: left and up clamp
    the flat index at 0, right and down wrap modulo the pixel count."""
    if amount <= 0.0:
        return img
    h, w = img.shape[:2]
    n = h * w
    flat = img.reshape(n, img.shape[2]).astype(np.float32)
    idx = np.arange(n, dtype=np.int64)
    left = np.maximum(idx - 1, 0)
    up = np.maximum(idx - w, 0)
    right = np.where(idx + 1 >= n, idx + 1 - n, idx + 1)
    down = np.where(idx + w >= n, idx + w - n, idx + w)
    center_w = 4.0 + 1.0 / amount
    out = (flat * center_w - flat[left] - flat[up] - flat[right]
           - flat[down]) / (center_w - 4.0)
    return np.maximum(out, 0.0).reshape(img.shape)


def load_training_image(path: str) -> np.ndarray:
    """LDR image -> (H, W, 4) float32 linear, premultiplied alpha
    (NerfDataset::set_training_image, nerf_loader.cu:756-856)."""
    from PIL import Image
    arr = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
    alpha = arr[..., 3:4]
    rgb = _srgb_to_linear_np(arr[..., :3]) * alpha
    return np.concatenate([rgb, alpha], axis=-1).astype(np.float32)


def _srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4)).astype(np.float32)

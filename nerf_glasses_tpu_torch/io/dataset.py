"""NeRF dataset metadata as a snapshot carries it.

Port of the part of nerf_glasses_tpu/io/dataset.py that loading a
snapshot needs (json_binding.h:133-204): the container and its json
parse. Training data loading is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from nerf_glasses_tpu_torch.utils.bbox import BoundingBox


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
    """Camera metadata in NGP space."""
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

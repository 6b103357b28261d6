"""Instant-NGP `.msgpack` snapshot reader and writer.

Port of nerf_glasses_tpu/io/snapshot.py (Testbed::load_snapshot,
src/ngp/testbed.cu:939-1002; tcnn Trainer::serialize, trainer.h:270-306;
dataset section json_binding.h:133-204): a MessagePack
document with the network config sections and a `snapshot` section
holding the fp16 params blob (tcnn order: density MLP, rgb MLP, hash
grid) and the Morton-ordered fp16 density grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import msgpack
import numpy as np

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io import dataset as ds_io
from nerf_glasses_tpu_torch.ops.occupancy import (linear_cascades_to_morton,
                                                  morton_cascades_to_linear)
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox


@dataclasses.dataclass
class Snapshot:
    config: NGPConfig
    params_blob: np.ndarray                  # fp32, tcnn layout
    density_grid: np.ndarray                 # (cascades, 128,128,128) f32 [z,y,x]
    dataset: ds_io.NerfDataset
    aabb: BoundingBox
    render_aabb: BoundingBox
    render_aabb_to_local: np.ndarray         # 3x3
    bounding_radius: float = 1.0
    training_step: int = 0
    loss: float = 0.0
    extra_dims: Optional[np.ndarray] = None  # inference latent codes (E,)


def load_snapshot(path: str) -> Snapshot:
    with open(path, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
    if "snapshot" not in doc:
        raise ValueError(f"File {path} does not contain a snapshot.")
    snap = doc["snapshot"]
    if snap.get("version", 0) < 1:
        raise ValueError("Snapshot uses an old format.")
    if int(snap["density_grid_size"]) != C.NERF_GRIDSIZE:
        raise ValueError("Incompatible grid size.")

    dataset = ds_io.dataset_from_json(snap["nerf"]["dataset"])
    config = NGPConfig.from_snapshot_config(doc, dataset.aabb_scale,
                                            dataset.is_hdr)

    dt = np.float16 if snap.get("params_type", "__half") == "__half" \
        else np.float32
    params = np.frombuffer(snap["params_binary"], dtype=dt).astype(np.float32)

    grid_fp16 = np.frombuffer(snap["density_grid_binary"], dtype=np.float16)
    n_cells = C.NERF_GRIDSIZE ** 3
    if grid_fp16.size % n_cells:
        raise ValueError("Bad density grid size.")
    n_casc = grid_fp16.size // n_cells
    if n_casc not in (0, config.max_cascade + 1):
        raise ValueError("Incompatible number of grid cascades.")
    if n_casc:
        grid = morton_cascades_to_linear(
            grid_fp16.astype(np.float32).reshape(n_casc, n_cells))
    else:
        grid = np.zeros((config.max_cascade + 1,) + (C.NERF_GRIDSIZE,) * 3,
                        np.float32)

    # load_nerf_post (testbed.cu:1098-1105): aabb from aabb_scale
    half = 0.5 * min(1 << (C.NERF_CASCADES - 1), dataset.aabb_scale)
    aabb = BoundingBox(np.full(3, 0.5 - half, np.float32),
                       np.full(3, 0.5 + half, np.float32))
    render_aabb = aabb.copy()
    if not dataset.render_aabb.is_empty():
        render_aabb = dataset.render_aabb.intersection(aabb)
    render_aabb_to_local = dataset.render_aabb_to_local.copy()
    if "render_aabb_to_local" in snap:
        render_aabb_to_local = np.asarray(snap["render_aabb_to_local"],
                                          np.float32)
    if "render_aabb" in snap:
        render_aabb = BoundingBox(np.asarray(snap["render_aabb"]["min"]),
                                  np.asarray(snap["render_aabb"]["max"]))

    return Snapshot(
        config=config,
        params_blob=params,
        density_grid=grid,
        dataset=dataset,
        aabb=aabb,
        render_aabb=render_aabb,
        render_aabb_to_local=render_aabb_to_local,
        bounding_radius=float(snap.get("bounding_radius", 1.0)),
        training_step=int(snap.get("training_step", 0)),
        loss=float(snap.get("loss", 0.0)),
        extra_dims=(np.frombuffer(snap["extra_dims_binary"], np.float16)
                    .astype(np.float32)
                    if "extra_dims_binary" in snap else None))


def save_snapshot(path: str, config: NGPConfig, params_blob: np.ndarray,
                  density_grid_linear: np.ndarray, dataset: ds_io.NerfDataset,
                  aabb: BoundingBox, render_aabb: BoundingBox,
                  render_aabb_to_local: np.ndarray,
                  bounding_radius: float = 1.0, training_step: int = 0,
                  loss: float = 0.0, rays_per_batch: int = 1 << 12,
                  measured_batch_size: int = 0,
                  measured_batch_size_before_compaction: int = 0,
                  extra_dims: Optional[np.ndarray] = None) -> None:
    """Write a reference-compatible snapshot: the params as fp16
    `params_binary`, the density grid as fp16 Morton order per cascade,
    clamped to the fp16 range (a trained optical thickness can exceed
    it), the dataset section, and `extra_dims_binary` when latent codes
    are given."""
    grid_morton = np.clip(
        linear_cascades_to_morton(np.asarray(density_grid_linear, np.float32)),
        -65504.0, 65504.0).astype(np.float16)
    params = np.asarray(params_blob, np.float32)
    doc = dict(config.to_snapshot_config())
    doc["snapshot"] = {
        "version": 1,
        "aabb": {"min": aabb.min.tolist(), "max": aabb.max.tolist()},
        "bounding_radius": float(bounding_radius),
        "density_grid_size": C.NERF_GRIDSIZE,
        "density_grid_binary": grid_morton.tobytes(),
        "render_aabb": {"min": render_aabb.min.tolist(),
                        "max": render_aabb.max.tolist()},
        "render_aabb_to_local": np.asarray(render_aabb_to_local).tolist(),
        "training_step": int(training_step),
        "loss": float(loss),
        "nerf": {
            "rgb": {
                "rays_per_batch": int(rays_per_batch),
                "measured_batch_size": int(measured_batch_size),
                "measured_batch_size_before_compaction": int(
                    measured_batch_size_before_compaction),
            },
            "dataset": ds_io.dataset_to_json(dataset),
            "aabb_scale": int(dataset.aabb_scale),
        },
        "n_params": int(params.size),
        "params_type": "__half",
        "params_binary": params.astype(np.float16).tobytes(),
    }
    if extra_dims is not None:
        doc["snapshot"]["extra_dims_binary"] = np.asarray(
            extra_dims, np.float32).astype(np.float16).tobytes()
    with open(path, "wb") as f:
        f.write(msgpack.packb(doc, use_bin_type=True))

"""pynmr_torch: the pynmr surface over the PyTorch port.

The counterpart of pynmr.py (reference: src/python_api.cu): the same names
over nerf_glasses_tpu_torch, so that the reference's `volume/render.py`
runs against the port with one changed line:

    import pynmr_torch as nmr
    renderer = nmr.NerfMeshRenderer(1280, 720)
    renderer.envmap("sky.png")
    nerf = renderer.load_nerf("nerf.msgpack")
    nerf.render_aabb.min = ...
    renderer.orbit(da, dp, dz)
    renderer.frame()
    im = nerf.render(W, H, linear=False)
    renderer.load_mesh(path, t=..., s=..., r=[w, x, y, z])
    renderer.remove_floaties()

Objects live on the CUDA device unless the caller passes device="cpu"
(NerfMeshRenderer(w, h, device=), Testbed(name, device=)). Importing this
module imports torch and numpy, never jax.
"""

import enum

import numpy as np
import torch

from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer  # noqa: F401
from nerf_glasses_tpu_torch.models.testbed import Testbed  # noqa: F401
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox  # noqa: F401
from nerf_glasses_tpu_torch.io.gltf import (GltfNode, GltfScene,  # noqa: F401
                                            GltfMesh)
from nerf_glasses_tpu_torch.io.dataset import NerfDataset  # noqa: F401


def free_temporary_memory():
    """tcnn::free_all_gpu_memory_arenas analogue: release PyTorch's cached,
    unused blocks of device memory (torch.cuda.empty_cache). Nothing to do
    without a CUDA device."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class LossType(enum.Enum):
    L2 = 0
    L1 = 1
    Mape = 2
    Smape = 3
    Huber = 4
    SmoothL1 = 4  # legacy alias
    LogL1 = 5
    RelativeL2 = 6


class NerfActivation(enum.Enum):
    Nothing = 0  # "None" in the reference enum
    ReLU = 1
    Logistic = 2
    Exponential = 3


class ColorSpace(enum.Enum):
    Linear = 0
    SRGB = 1


class TonemapCurve(enum.Enum):
    Identity = 0
    ACES = 1
    Hable = 2
    Reinhard = 3


class LensMode(enum.Enum):
    Perspective = 0
    OpenCV = 1
    FTheta = 2
    LatLong = 3


class GroundTruthRenderMode(enum.Enum):
    Shade = 0
    Depth = 1


def Vec3(x=0.0, y=0.0, z=0.0):
    return np.array([x, y, z], np.float32)

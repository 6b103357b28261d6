"""nerf_glasses_tpu_torch — the hybrid NeRF + mesh renderer in PyTorch and
CUDA, for one NVIDIA H100.

A port of nerf_glasses_tpu (JAX on a TPU), which stays beside it as the
reference: the layout and the function names follow that package, so
every function here has an obvious counterpart there. The package
imports torch and numpy and never jax.

Layout:
    ops/       compute on tensors (hash grid, SH, MLP, march, bake,
               colours, mesh pass) and the hand-written CUDA kernels'
               wrappers
    csrc/      CUDA C++ sources, built with nvcc at first use
    models/    stateful user-facing objects (Testbed, NerfMeshRenderer)
    parallel/  the hybrid frame as one row-sharded program
    io/        snapshot (msgpack), glTF, dataset metadata
    utils/     bounding boxes, cameras, quaternions

Devices are explicit: Testbed and NerfMeshRenderer take `device=`
(default "cuda"); nothing probes for a GPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (camera rays `ndc @ cam.T`, the render-aabb transform
# `pos @ local.T`, mesh transforms) must run in full fp32: the JAX
# package forces f32 matmuls for the same reason (reduced-precision ray
# directions break the voxel DDA). TF32 would keep ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

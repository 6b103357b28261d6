"""Count the aten operations of one training step of the port on the CPU,
by stage: the leaf operations that compute (views, empties and scalar
reads left out), under torch.profiler, each charged to the stage that
called it (the draws, the pixels, the rays, the hop pass, the keep set,
the forward, the backward, Adam, the error map).

    python3 tools/train_step_ops.py [RAYS]

The step is native_fast's at RAYS rays (default 256) x 48 samples on a
two-image noise scene, after 20 steps, on a step that refreshes no
grid. On the CPU every wrapper runs its plain version, so the counts are
those of the plain pieces; the counts do not depend on the batch. The
backward's operations run on autograd's engine: those the profiler
links to no stage's frame are counted under "other". A count of
operations, not a device metric: the device's are chip_smoke.py phase
14's.
"""
import collections
import math
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_glasses_tpu_torch.config import NGPConfig  # noqa: E402
from nerf_glasses_tpu_torch.io.dataset import (ImageMetadata,  # noqa: E402
                                               NerfDataset)
from nerf_glasses_tpu_torch.train import trainer as ttr  # noqa: E402

# operations that move or read no tensor data
NOT_COMPUTE = {
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::view",
    "aten::reshape", "aten::_reshape_alias", "aten::_unsafe_view",
    "aten::as_strided", "aten::expand", "aten::expand_as", "aten::select",
    "aten::slice", "aten::narrow", "aten::unsqueeze", "aten::squeeze",
    "aten::t", "aten::transpose", "aten::permute", "aten::numpy_T",
    "aten::detach", "aten::alias", "aten::resolve_conj", "aten::resolve_neg",
    "aten::lift_fresh", "aten::result_type", "aten::item",
    "aten::_local_scalar_dense", "aten::is_nonzero", "aten::unbind",
    "aten::split", "aten::split_with_sizes", "aten::chunk", "aten::set_",
    "aten::size", "aten::stride", "aten::contiguous", "aten::view_as",
    "aten::broadcast_tensors"}
STAGES = {"draw_step": "draws", "_sample_pixels": "pixels",
          "_gen_rays": "rays", "march_training_samples": "hop pass",
          "compact_sample_sel": "keep set", "forward_rays": "forward",
          "adam_update": "adam", "_error_map_accum": "error map",
          "_error_map_apply": "error map"}


def dataset(n_img=2, w=64, seed=0):
    """Two noise images from cameras looking at the unit cube."""
    rng = np.random.default_rng(seed)
    ds = NerfDataset()
    ds.n_images = n_img
    ds.metadata = [ImageMetadata(resolution=(w, w), focal_length=(w, w),
                                 principal_point=(0.5, 0.5))
                   for _ in range(n_img)]
    xf = []
    for i in range(n_img):
        a = 0.4 * i
        rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                        [-math.sin(a), 0, math.cos(a)]])
        xf.append(np.concatenate([rot, (0.5 - 1.8 * rot[:, 2])[:, None]], 1))
    ds.xforms = np.asarray(xf, np.float32)
    ds.xforms_end = ds.xforms.copy()
    ds.paths = [f"img_{i}" for i in range(n_img)]
    ds.images = [rng.uniform(0, 1, (w, w, 4)).astype(np.float32)
                 for _ in range(n_img)]
    return ds


def staged(fn, label):
    def call(*a, **k):
        with record_function("STAGE:" + label):
            return fn(*a, **k)
    return call


def main(rays):
    torch.set_num_threads(4)
    opts = ttr.TrainOptions(config=NGPConfig.native_fast(),
                            rays_per_batch=rays)
    tr = ttr.Trainer(dataset(), opts, seed=3, device="cpu")
    tr.occ_warmup_steps = 0
    tr.train(20)
    if tr.step % opts.grid_update_interval == 0:
        tr.train(1)
    for name, label in STAGES.items():
        setattr(ttr, name, staged(getattr(ttr, name), label))
    torch.autograd.grad = staged(torch.autograd.grad, "backward")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(1)
    counts = collections.Counter()
    for e in prof.events():
        if (not e.name.startswith("aten::") or e.name in NOT_COMPUTE
                or any(c.name.startswith("aten::") for c in e.cpu_children)):
            continue
        stage, p = "other", e.cpu_parent
        while p is not None:
            if p.name.startswith("STAGE:"):
                stage = p.name[6:]
                break
            p = p.cpu_parent
        counts[stage] += 1
    print(f"one native_fast training step on the CPU ({rays} rays x "
          f"{opts.samples_per_ray} samples, compaction gate open "
          f"{tr._compact_ready}): {sum(counts.values())} leaf aten "
          f"operations that compute")
    for stage, n in counts.most_common():
        print(f"  {stage}: {n}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)

"""Train a NeRF from a transforms.json dataset and save nerf.msgpack.

Port of nerf_glasses_tpu/apps/train_app.py (the reference volume/train.py
contract): stop at loss < TARGET_LOSS or MAX_TRAINING_STEPS steps, and
write nerf.msgpack beside the dataset. Trains on DEVICE.

Usage: python -m nerf_glasses_tpu_torch.apps.train_app <dataset_dir_or_json>
"""

from __future__ import annotations

import os
import sys

TARGET_LOSS = 0.00175
MAX_TRAINING_STEPS = 10000
DEVICE = "cuda"


def main(argv=None):
    argv = argv or sys.argv
    dataset_path = argv[1]

    from nerf_glasses_tpu_torch.io.dataset import load_transforms_json
    from nerf_glasses_tpu_torch.train.trainer import Trainer

    ds = load_transforms_json(dataset_path, load_images=True)
    trainer = Trainer(ds, device=DEVICE)
    loss = trainer.train_until(TARGET_LOSS, MAX_TRAINING_STEPS)
    print("\nTraining complete with loss", loss)

    snapshot_path = dataset_path
    if not os.path.isdir(snapshot_path):
        snapshot_path = os.path.dirname(snapshot_path)
    snapshot_path = os.path.join(snapshot_path, "nerf.msgpack")
    trainer.save_snapshot(snapshot_path)
    print("saved", snapshot_path)
    return snapshot_path


if __name__ == "__main__":
    main()

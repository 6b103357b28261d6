"""End-to-end training with the PyTorch port on the CPU: the Trainer on
the synthetic sphere of tests/test_training.py, the pyngp-style Testbed
surface, the train_app entry point, and the render paths' autograd
hygiene after training.

Bars are the JAX tests' own (tests/test_training.py:106-140): loss under
0.03 and under half the early loss, density > 5 only near the sphere
(< 5% of hot cells beyond r + 0.1), centre density > 5x a corner's.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_glasses_tpu.io import snapshot as jsnap
from nerf_glasses_tpu_torch.apps import train_app
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io import snapshot as tsnap
from nerf_glasses_tpu_torch.models.testbed import Testbed
from nerf_glasses_tpu_torch.train.trainer import TrainOptions, Trainer
from tests.test_apps import write_disk_dataset
from tests.test_torch_dataset import port_dataset
from tests.test_training import SPHERE_C, SPHERE_R, make_synth_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = NGPConfig(n_levels=8, log2_hashmap_size=13, base_resolution=16,
                 per_level_scale=1.61)


@pytest.fixture(scope="module")
def trained():
    opts = TrainOptions(config=TINY, rays_per_batch=512, samples_per_ray=32,
                        grid_samples_per_update=1 << 14,
                        compute_dtype="float32", encode_dtype="float32")
    tr = Trainer(port_dataset(make_synth_dataset()), opts, seed=3,
                 device="cpu")
    tr.occ_warmup_steps = 64
    tr.train(20)
    early = tr.loss
    tr.train(230)
    return tr, early


def test_loss_decreases(trained):
    tr, early = trained
    assert np.isfinite(tr.loss)
    assert tr.loss < early * 0.5
    assert tr.loss < 0.03
    assert len(tr.loss_history) == min(250, tr.loss_history_capacity)


def test_density_concentrates_on_sphere(trained):
    tr, _ = trained
    tb = tr.to_testbed()
    inside = tb.density_at(np.array([SPHERE_C]))
    outside = tb.density_at(np.array([[0.15, 0.85, 0.15]]))
    assert inside[0] > outside[0] * 5
    g = np.linspace(0.05, 0.95, 16)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    hot = pts[tb.density_at(pts.astype(np.float32)) > 5.0]
    assert len(hot) > 20, "no solid density learned at all"
    r = np.linalg.norm(hot - SPHERE_C, axis=1)
    assert (r > SPHERE_R + 0.1).mean() < 0.05


def test_to_testbed_is_a_copy(trained):
    tr, _ = trained
    tb = tr.to_testbed()
    assert not any(p.requires_grad for p in tb.net.parameters())
    before = tb.net.grid.clone()
    tr.train(1)
    assert torch.equal(tb.net.grid, before)
    assert not torch.equal(tr.net.grid.detach(), before)


def test_pyngp_style_training_surface(tmp_path):
    """The reference train.py protocol: load_training_data, shall_train,
    frame() steps, sync_from_trainer, save_snapshot; the snapshot loads
    in both packages."""
    d = write_disk_dataset(tmp_path)
    tb = Testbed(device="cpu")
    tb.config = NGPConfig(n_levels=4, log2_hashmap_size=11,
                          base_resolution=16, per_level_scale=1.7)
    tb.load_training_data(str(d))
    tb.shall_train = True
    tb._trainer = Trainer(tb.dataset, TrainOptions(
        config=tb.config, rays_per_batch=512, samples_per_ray=32,
        grid_samples_per_update=1 << 12, compute_dtype="float32"),
        device="cpu")
    tb._trainer.occ_warmup_steps = 1 << 30
    losses = []
    for _ in range(30):
        assert tb.frame()
        losses.append(tb.loss)
    assert tb.training_step == 30
    assert np.isfinite(losses[-1])
    assert tb.get_camera_extrinsics(0).shape == (3, 4)
    snap = tmp_path / "nerf.msgpack"
    tb.sync_from_trainer()
    tb.save_snapshot(str(snap))
    tb2 = Testbed(device="cpu")
    tb2.load_snapshot(str(snap))
    assert tb2.training_step == 30
    assert jsnap.load_snapshot(str(snap)).training_step == 30


def test_render_paths_build_no_graph(trained):
    """A Testbed that trains renders the trainer's live network, whose
    parameters require grad: frames, the bake and density queries must
    build no autograd graph."""
    tr, _ = trained
    tb = Testbed(device="cpu")
    tb.dataset = tr.dataset
    tb._trainer = tr
    tb.train(1)
    assert tb.net is tr.net and tb.net.grid.requires_grad
    tb.march_overrides = {"jitter": False, "max_rounds": 16,
                          "compute_dtype": "float32"}
    frame, depth = tb.render_frame_buffers(24, 16)
    assert frame.grad_fn is None and not frame.requires_grad
    assert depth.grad_fn is None
    tb.bake(32, features=True)
    assert tb._baked_sigma.grad_fn is None and tb._baked_feat.grad_fn is None
    assert np.isfinite(tb.density_at(np.full((4, 3), 0.5, np.float32))).all()
    assert torch.is_grad_enabled()


def test_train_app_main(tmp_path, monkeypatch):
    """train_app.main with MAX_TRAINING_STEPS bounded writes nerf.msgpack
    beside the dataset; both packages load it."""
    d = write_disk_dataset(tmp_path, n_images=2)
    monkeypatch.setattr(train_app, "MAX_TRAINING_STEPS", 2)
    monkeypatch.setattr(train_app, "DEVICE", "cpu")
    out = train_app.main(["train_app", str(d)])
    assert out == os.path.join(str(d), "nerf.msgpack")
    s = tsnap.load_snapshot(out)
    j = jsnap.load_snapshot(out)
    assert s.training_step == j.training_step == 2
    assert s.config.n_levels == j.config.n_levels == 16
    assert s.config.log2_hashmap_size == 19
    np.testing.assert_array_equal(s.params_blob, j.params_blob)
    np.testing.assert_array_equal(s.density_grid, j.density_grid)


def test_port_imports_without_jax():
    """The port, its trainer and its train entry point import with jax
    unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import nerf_glasses_tpu_torch.train.trainer, "
            "nerf_glasses_tpu_torch.apps.train_app, "
            "nerf_glasses_tpu_torch.models.renderer, "
            "nerf_glasses_tpu_torch.parallel.sharding; "
            "assert not any(m == 'nerf_glasses_tpu' or "
            "m.startswith('nerf_glasses_tpu.') for m in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

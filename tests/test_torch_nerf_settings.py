"""`testbed.nerf` settings, the save_snapshot signature and trainer-made
multi-cascade Testbeds in the PyTorch port against the JAX package.

- Each `tb.nerf` property is set to the same value on both packages: the
  port's frame must change from its default frame (by more than 1e-3
  somewhere) and stay >= 50 dB from the JAX frame (float32 MLPs, no
  jitter, 40x32, the tests/helpers.py sphere snapshot).
- The camera features nerf.render_with_lens_distortion,
  snap_to_pixel_centers and aperture_size change the port's frame as
  they change the JAX frame (>= 50 dB); tests/test_torch_lens.py holds
  each camera feature in detail.
- save_snapshot(path, include_optimizer_state) takes the pyngp argument.
- A short aabb_scale 4 training run: to_testbed, Testbed.train and
  sync_from_trainer give Testbeds that render through the multi-cascade
  paths, bake, save and load again with equal frames (atol 2e-3: the
  snapshot stores float16 parameters and grid), and agree with the JAX
  trainer's Testbed built from the same carried-across state (>= 50 dB
  exact, >= 40 dB baked + flash).
"""

import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.train.trainer import TrainOptions as JTrainOptions
from nerf_glasses_tpu.train.trainer import Trainer as JTrainer
from nerf_glasses_tpu.utils.bbox import BoundingBox as JBox
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.models.testbed import (NerfRenderSettings,
                                                   Testbed as TTestbed)
from nerf_glasses_tpu_torch.train.trainer import TrainOptions, Trainer
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox as TBox
from tests.helpers import write_test_snapshot
from tests.test_torch_dataset import port_dataset
from tests.test_training import make_synth_dataset

torch.set_num_threads(1)

W, H = 40, 32
FAST = {"max_rounds": 96, "jitter": False, "compute_dtype": "float32"}


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    p = tmp_path_factory.mktemp("settings") / "sphere.msgpack"
    write_test_snapshot(p)
    return str(p)


def _pair(snapshot):
    j, t = JTestbed(), TTestbed(device="cpu")
    for tb in (j, t):
        tb.load_snapshot(snapshot)
        tb.march_overrides = dict(FAST)
    return j, t


def _render(tb):
    return np.asarray(tb.render(W, H, spp=1, linear=True))


class _Enum:
    """Stands in for a pyngp enum value: str() gives "Activation.Name"."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return f"NerfActivation.{self.name}"


def _set_min_transmittance(tb):
    tb.nerf.render_min_transmittance = 0.8
    assert tb.nerf.rendering_min_transmittance == 0.8


def _set_cone_angle(tb):
    tb.nerf.cone_angle_constant = 1.0 / 64.0
    assert tb.nerf.cone_angle_constant == 1.0 / 64.0


def _set_rgb_activation(tb):
    tb.nerf.rgb_activation = _Enum("Exponential")
    assert tb.nerf.rgb_activation == "exponential"


def _set_density_activation(tb):
    tb.nerf.density_activation = "logistic"
    assert tb.config.density_activation == "logistic"


def _set_render_aabb(tb):
    box = (TBox if isinstance(tb, TTestbed) else JBox)(
        [0.0, 0.0, 0.0], [0.5, 1.0, 1.0])
    tb.nerf.render_aabb = box
    assert tb.render_aabb is box and tb.nerf.render_aabb is box


def _set_linear_colors(tb):
    tb.nerf.training.linear_colors = True
    assert tb.nerf.training.dataset is tb.dataset


SETTERS = {"render_min_transmittance": _set_min_transmittance,
           "cone_angle_constant": _set_cone_angle,
           "rgb_activation": _set_rgb_activation,
           "density_activation": _set_density_activation,
           "render_aabb": _set_render_aabb,
           "training_linear_colors": _set_linear_colors}


@pytest.mark.parametrize("name", list(SETTERS))
def test_nerf_setting_changes_the_frame_as_in_jax(snapshot, name):
    j, t = _pair(snapshot)
    assert isinstance(t.nerf, NerfRenderSettings)
    base_j, base_t = _render(j), _render(t)
    assert psnr(base_t, base_j) >= 50.0
    SETTERS[name](j)
    SETTERS[name](t)
    new_j, new_t = _render(j), _render(t)
    assert np.abs(new_j - base_j).max() > 1e-3      # the reference reacts
    assert np.abs(new_t - base_t).max() > 1e-3      # and so does the port
    assert psnr(new_t, new_j) >= 50.0, psnr(new_t, new_j)


def test_changed_density_activation_reaches_the_bake(snapshot):
    """The network object keeps the snapshot's config; an activated
    (sigma_log=False) bake must take the Testbed's."""
    j, t = _pair(snapshot)
    for tb in (j, t):
        tb.nerf.density_activation = "logistic"
        tb.bake(32, sigma_log=False)
    assert t.net.config.density_activation == "exponential"
    sig = t._baked_sigma
    assert float(sig.max()) <= 1.0 and float(sig.max()) > 0.3
    assert psnr(_render(t), _render(j)) >= 40.0


def test_render_min_transmittance_alias(snapshot):
    """tb.render_min_transmittance, which the port read before it had
    nerf.render_min_transmittance, is the same setting."""
    _, t = _pair(snapshot)
    t.render_min_transmittance = 0.8
    assert t.nerf.render_min_transmittance == 0.8
    assert t._march_options().min_transmittance == 0.8
    t.nerf.render_min_transmittance = 0.25
    assert t.render_min_transmittance == 0.25
    assert t._march_options().min_transmittance == 0.25


def test_inert_settings_are_kept():
    j, t = JTestbed(), TTestbed(device="cpu")
    for name in ("sharpen", "visualize_cameras", "glow_y_cutoff", "glow_mode",
                 "render_with_lens_distortion"):
        assert getattr(t.nerf, name) == getattr(j.nerf, name), name
    t.nerf.glow_mode = 2
    t.nerf.glow_y_cutoff = 0.5
    t.nerf.visualize_cameras = True
    t.nerf.sharpen = 0.3
    assert (t.nerf.glow_mode, t.nerf.glow_y_cutoff, t.nerf.sharpen) == (
        2, 0.5, 0.3)
    assert t.snap_to_pixel_centers == j.snap_to_pixel_centers
    assert t.aperture_size == 0.0


def _lens_on(tb):
    tb.dataset.metadata[0].lens_mode = "opencv"
    tb.dataset.metadata[0].lens_params = (0.3, 0.05, 0.01, 0.01, 0, 0, 0)
    tb.nerf.render_with_lens_distortion = True


def _snap_on(tb):
    tb.snap_to_pixel_centers = True


def _aperture_on(tb):
    tb.aperture_size = 0.05


CAMERA_FEATURES = {"render_with_lens_distortion": _lens_on,
                   "snap_to_pixel_centers": _snap_on,
                   "aperture_size": _aperture_on}


@pytest.mark.parametrize("case", list(CAMERA_FEATURES))
def test_unported_camera_features_raise(snapshot, case):
    """The three camera features that raised before the port had them:
    each is stored, changes the frame (snapping: the frame of sample 3,
    whose Halton offset is not the pixel centre) and stays >= 50 dB from
    the JAX frame."""
    j, t = _pair(snapshot)

    def frame(tb):
        return np.asarray(tb.render_frame_buffers(W, H, 3)[0])

    base_t = frame(t)
    for tb in (j, t):
        CAMERA_FEATURES[case](tb)
    target = t.nerf if case == "render_with_lens_distortion" else t
    assert getattr(target, case) == getattr(
        j.nerf if case == "render_with_lens_distortion" else j, case)
    new_j, new_t = frame(j), frame(t)
    assert np.abs(new_t - base_t).max() > 1e-3
    assert psnr(new_t, new_j) >= 50.0, psnr(new_t, new_j)


def test_save_snapshot_takes_the_pyngp_argument(snapshot, tmp_path):
    j, t = _pair(snapshot)
    t.save_snapshot(str(tmp_path / "a.msgpack"), False)
    t.save_snapshot(str(tmp_path / "b.msgpack"),
                    include_optimizer_state=True)
    j.save_snapshot(str(tmp_path / "c.msgpack"), False)
    frames = []
    for name in "abc":
        tb = TTestbed(device="cpu")
        tb.load_snapshot(str(tmp_path / f"{name}.msgpack"))
        tb.march_overrides = dict(FAST)
        frames.append(_render(tb))
    np.testing.assert_array_equal(frames[0], frames[1])
    np.testing.assert_array_equal(frames[0], frames[2])
    assert frames[0][..., 3].max() > 0.1


# ---------------------------------------------------------------------------
# A trainer-made aabb_scale 4 Testbed
# ---------------------------------------------------------------------------

CFG4 = NGPConfig(n_levels=8, log2_hashmap_size=13, base_resolution=16,
                 per_level_scale=1.61, aabb_scale=4)
CAM = np.array([[0.5, 0.0, 0.0, 0.0],
                [0.0, -0.5, 0.0, 0.0],
                [0.0, 0.0, 1.0, -1.7]], np.float32)


def _dataset4():
    jd = make_synth_dataset()
    jd.aabb_scale = 4
    jd.render_aabb = JBox([-1.5] * 3, [2.5] * 3)
    return jd


@pytest.fixture(scope="module")
def trained4():
    jd = _dataset4()
    opts = TrainOptions(config=CFG4, rays_per_batch=256, samples_per_ray=32,
                        grid_samples_per_update=1 << 13,
                        compute_dtype="float32", encode_dtype="float32")
    tr = Trainer(port_dataset(jd), opts, seed=3, device="cpu")
    tr.occ_warmup_steps = 16
    tr.train(48)
    return tr, jd


def _frame(tb, flash=False):
    tb.march_overrides = {"max_rounds": 64, "jitter": False,
                          "compute_dtype": "float32"}
    tb.camera_matrix = CAM
    tb.flash = flash
    frame, _ = tb.render_frame_buffers(W, H)
    return np.asarray(frame)


def test_trainer_testbed_renders_saves_and_reloads(trained4, tmp_path):
    tr, jd = trained4
    tb = tr.to_testbed()
    assert tb.config.max_cascade == 2 and tb.density_grid.shape[0] == 3
    assert np.allclose(tb.aabb.min, -1.5) and np.allclose(tb.aabb.max, 2.5)
    assert tb._cone_angle == pytest.approx(1.0 / 256.0)
    opts = tb._march_options()
    assert opts.dist_advance and "dist_mips" in tb._scene()
    exact = _frame(tb)
    assert np.isfinite(exact).all() and tb.last_render_path == "unbaked"
    assert exact[..., 3].max() > 0.05
    snap = str(tmp_path / "nerf4.msgpack")
    tb.save_snapshot(snap, False)

    again = TTestbed(device="cpu")
    again.load_snapshot(snap)
    assert again.config == tb.config and again.training_step == 48
    np.testing.assert_allclose(_frame(again), exact, atol=2e-3)

    # the same state through the JAX trainer
    jtr = JTrainer(jd, JTrainOptions(
        config=type(JTestbed().config)(**{
            f: getattr(CFG4, f) for f in CFG4.__dataclass_fields__}),
        rays_per_batch=256, samples_per_ray=32))
    jtr.load_snapshot(snap)
    jtb = jtr.to_testbed()
    assert jtb.config.max_cascade == 2
    np.testing.assert_array_equal(again.occ.numpy(), np.asarray(jtb.occ))
    assert psnr(_frame(again), _frame(jtb)) >= 50.0

    for b in (again, jtb):
        b.bake(64)
    assert again._baked_sigma.shape == (3, 64, 64, 64)
    flash_t, flash_j = _frame(again, flash=True), _frame(jtb, flash=True)
    assert again.last_render_path == "flash"
    assert psnr(flash_t, flash_j) >= 40.0, psnr(flash_t, flash_j)


def test_testbed_train_and_sync_hand_back_multicascade_testbeds(trained4):
    """Testbed.train adopts the trainer's config, cone angle and training
    box (a fresh Testbed stands on the unit cube); sync_from_trainer
    adopts a copy. Both render what to_testbed renders."""
    tr, _ = trained4
    want = tr.to_testbed()
    live = TTestbed(device="cpu")
    live.dataset = tr.dataset
    live._trainer = tr
    step = tr.step
    live.train(0)
    assert tr.step == step and live.net is tr.net
    assert live.config.max_cascade == 2
    assert live._cone_angle == pytest.approx(1.0 / 256.0)
    assert np.allclose(live.aabb.min, -1.5) and np.allclose(live.aabb.max, 2.5)
    assert np.allclose(live.render_aabb.max, 2.5)
    assert live._march_options().dist_advance
    np.testing.assert_allclose(_frame(live), _frame(want), atol=1e-6)

    synced = TTestbed(device="cpu")
    synced.dataset = tr.dataset
    synced._trainer = tr
    synced.sync_from_trainer()
    assert synced.net is not tr.net and synced.config.max_cascade == 2
    np.testing.assert_allclose(_frame(synced), _frame(want), atol=1e-6)
    synced.bake(32)
    assert synced._baked_sigma.shape == (3, 32, 32, 32)
    assert np.isfinite(_frame(synced, flash=True)).all()

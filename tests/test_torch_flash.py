"""The flash fast path: the port's flash init, baked march and deferred
shade against the JAX package, on the same seeded inputs, with
params_from_jax weights, float32 MLPs and jitter off.

Tolerances:
- flash_init: alive masks equal; floors to rtol 1e-6 (the camera inverse
  and projection are float32 in both, summed in another order).
- Frames are compared as linear premultiplied RGBA (linear_colors=True,
  so no sRGB curve amplifies a difference). The JAX package colours
  whole 4096-sample windows of its significance partition and shades
  whole chunk-sized windows of rays, so it also colours some
  non-significant samples and shades some rays with wn <= 1e-4; the port
  colours exactly the significant samples and shades each ray with
  wn > 1e-4 once (ops/raymarch.py). Hence:
  * at sig_threshold=0 every non-significant valid sample has weight 0
    and the frames agree to EXACT_ATOL = 1e-5 (float summation order,
    brick vs dense sigma sampler);
  * at the default threshold the colour passes differ by what JAX's
    windows add: 0 <= J - P <= (P at threshold 0) - P, the colour the
    non-significant samples carry, which the test computes per pixel
    (plus EXACT_ATOL);
  * the deferred shade's tails add at most 1e-4 x colour per ray.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.renderer import NerfMeshRenderer as JRenderer
from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops.bake import pack_sigma_bricks
from nerf_glasses_tpu.ops.network import init_params
from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer as TRenderer
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops.network import params_from_jax
from tests.helpers import opaque_params, write_test_snapshot
from tests.test_flash_failures import CFG, _cam, _thin_slab_mask
from tests.test_torch_march import _np_params, _tcfg

torch.set_num_threads(1)

W = H = 64
EXACT_ATOL = 1e-5
SHADE_TAIL = 1e-4      # wn of a ray the JAX shade windows may add
BASE = dict(jitter=False, compute_dtype="float32", use_baked_sigma=True,
            max_rounds=64)
# the option bundles of bench.py:112-116 (Testbed._march_options' flash
# bundle, its per-sample feature-colour variant, and baked sigma with
# per-sample network colour)
FLASH = dict(deferred_color=True, lowres_factor=8, advance_iters=24,
             vector_rounds=True, steps_per_round=16, chunk=1 << 11,
             vector_occ_gate=False)
BUNDLES = {"flash": FLASH,
           "flash_featcolor": {**FLASH, "deferred_color": False,
                               "feat_color": True},
           "baked_sigcolor": {}}


def _sphere_mask(radius):
    g = (np.arange(128) + 0.5) / 128
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2) < radius


def _floater_mask():
    m = np.zeros((128, 128, 128), bool)
    m[60:63, 60:63, 60:63] = True
    return m


# tests/test_flash_failures.py's scenes: (mask, baked sigma, params seed)
SCENES = {"thin_slab": (_thin_slab_mask, 30.0, 0),
          "grazing_sphere": (lambda: _sphere_mask(0.28), 30.0, 1),
          "floater": (_floater_mask, 80.0, 2)}


def _scenes(mask, sigma, occ_pts=True, seed=0):
    """Occupancy, a 64^3 baked sigma grid (cells whose 2^3 source block is
    occupied), occupied voxel centres and a random bf16 feature grid ->
    (JAX scene with the brick table, port scene with the dense grid)."""
    occ = np.zeros((8, 128, 128, 128), np.uint8)
    occ[:] = mask.astype(np.uint8)[None]
    box = (np.zeros(3), np.ones(3), np.eye(3), np.zeros(3), np.ones(3))
    m = mask.reshape(64, 2, 64, 2, 64, 2).any(axis=(1, 3, 5))
    grid = np.where(m, sigma, 0.0).astype(np.float32)
    feat = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, (64 ** 3, 16)).astype(np.float32)).bfloat16()
    js = jrm.make_scene(occ, *box)
    js["sigma"] = pack_sigma_bricks(grid)
    js["feat"] = jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16)
    ts = trm.make_scene(occ, *box)
    ts["sigma"] = torch.as_tensor(grid)
    ts["feat"] = feat
    if occ_pts:
        pts = (np.argwhere(mask).astype(np.float32)[:, ::-1] + 0.5) / 128.0
        js["occ_pts"] = jnp.asarray(pts)
        ts["occ_pts"] = torch.as_tensor(pts)
    return js, ts


def _opts(**kw):
    kw = {**BASE, **kw}
    return (jrm.MarchOptions(config=CFG, **kw),
            trm.MarchOptions(config=_tcfg(CFG), **kw))


# ---------------------------------------------------------------------------
# Coarse init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["splat", "raywalk_safe", "raywalk_cull"])
def test_flash_init_matches_jax(mode):
    js, ts = _scenes(_sphere_mask(0.28), 30.0, occ_pts=mode == "splat")
    jo, to = _opts(**FLASH, lowres_cull=mode == "raywalk_cull")
    w, h = 100, 70              # not multiples of F: ragged coarse cells
    cam = _cam()
    jt, ja = jrm.flash_init(js, jnp.asarray(cam), w, h, jo)
    tt, ta = trm.flash_init(ts, torch.as_tensor(cam), w, h, to)
    assert tt.shape == (9, 13) and ta.dtype == torch.bool
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-6)
    assert 0 < ta.sum() < ta.numel() or mode == "raywalk_safe"
    jtu, jau = jrm.upsample_flash_init(jt, ja, w, h, 8)
    ttu, tau = trm.upsample_flash_init(tt, ta, w, h, 8)
    assert ttu.shape == (w * h,)
    np.testing.assert_array_equal(tau.numpy(), np.asarray(jau))
    np.testing.assert_allclose(ttu.numpy(), np.asarray(jtu), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _render(params, net, js, ts, **kw):
    jo, to = _opts(**kw)
    jf, _ = jrm.render_image_device(params, js, _cam(), W, H, jo,
                                    linear_colors=True)
    tf, _, _ = trm.render_image_device(net, ts, _cam(), W, H, to,
                                       linear_colors=True)
    return np.asarray(jf), tf.numpy()


@pytest.mark.parametrize("bundle", list(BUNDLES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_flash_frames_match_jax(scene, bundle):
    make_mask, sigma, seed = SCENES[scene]
    js, ts = _scenes(make_mask(), sigma, seed=seed)
    params = init_params(jax.random.PRNGKey(seed), CFG)
    net = params_from_jax(_np_params(params), _tcfg(CFG))
    kw = BUNDLES[bundle]
    # exact where the two colour rules coincide
    j0, t0 = _render(params, net, js, ts, **kw, sig_threshold=0.0)
    assert np.isfinite(t0).all()
    assert ((t0[..., 3] > 0.3).sum() == (j0[..., 3] > 0.3).sum())
    tail = SHADE_TAIL if kw.get("deferred_color") else 0.0
    np.testing.assert_allclose(t0, j0, atol=EXACT_ATOL + tail)
    # defaults: J - P lies within the colour of the non-significant samples
    jd, td = _render(params, net, js, ts, **kw)
    np.testing.assert_allclose(td[..., 3], jd[..., 3], atol=EXACT_ATOL)
    diff = (jd - td)[..., :3]
    bound = (t0 - td)[..., :3]
    assert (bound >= -EXACT_ATOL).all()
    assert (diff >= -EXACT_ATOL - tail).all()
    assert (diff <= bound + EXACT_ATOL + tail).all()


def test_opaque_sphere_testbed_bake_matches_jax(tmp_path):
    """tests/test_bake.py's opaque sphere through Testbed.bake(128): the
    baked (baked_sigcolor), deferred, flash and flash_featcolor renders
    of both packages (log-space bake, bf16 density MLP in both bakes; the
    render itself float32, no jitter). atol 1e-4: the colour-window and
    shade-tail bounds of the module docstring on a constant-colour
    sphere, plus one bfloat16 step of a baked feature (test_torch_bake)."""
    snap = tmp_path / "s.msgpack"
    write_test_snapshot(snap, params=opaque_params(sigma_raw=6.0))
    frames = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(str(snap))
        tb.march_overrides = {"max_rounds": 64, "jitter": False,
                              "compute_dtype": "float32"}
        tb.bake(128)
        out = [tb.render(64, 48, spp=1, linear=True)]
        tb.deferred_shading = True
        out.append(tb.render(64, 48, spp=1, linear=True))
        tb.flash = True
        out.append(tb.render(64, 48, spp=1, linear=True))
        assert tb.last_render_path == "flash"
        tb.march_overrides.update(deferred_color=False, feat_color=True)
        out.append(tb.render(64, 48, spp=1, linear=True))
        frames.append(out)
    for j, t in zip(*frames):
        assert np.isfinite(t).all() and (t[..., 3] > 0.99).mean() > 0.1
        np.testing.assert_allclose(t, j, atol=1e-4)


# ---------------------------------------------------------------------------
# load_nerf(bake=True) and the fidelity ladder (tests/test_bake.py:165-224)
# ---------------------------------------------------------------------------

def test_load_nerf_bake_flag(tmp_path):
    snap = tmp_path / "s.msgpack"
    write_test_snapshot(snap, params=opaque_params(sigma_raw=6.0))
    r = TRenderer(32, 24, device="cpu")
    nerf = r.load_nerf(str(snap), bake=True, bake_resolution=64,
                       feat_resolution=64)
    assert nerf.flash and nerf._baked_sigma is not None
    assert nerf.bake_fidelity[1] == "ok"
    assert nerf._scene()["feat"].shape == (64 ** 3, 16)
    r.frame()
    assert nerf.last_render_path == "flash"
    assert np.isfinite(r.display_image()).all()


def _slab_snapshot(tmp_path):
    slab = np.zeros((1, 128, 128, 128), np.float32)
    slab[0, :, :, 63:65] = 0.05          # thin YZ slab at x=0.5 ([z,y,x])
    snap = tmp_path / "slab.msgpack"
    write_test_snapshot(snap, density_grid=slab,
                        params=opaque_params(sigma_raw=6.0))
    return str(snap)


@pytest.mark.parametrize("bake_res,thr,action",
                         [(64, 30.0, "baked_only"), (16, 60.0, "unbaked")])
def test_load_nerf_bake_probe_ladder_matches_jax(tmp_path, bake_res, thr,
                                                 action):
    """The thin slab seen from the training view: flash scores far below
    30 dB, the gate does not save it, baked-only does; at 16^3 and a 60 dB
    threshold the ladder unbakes. Each step warns as in the JAX package,
    and the port's probe lands where the JAX package's does (PSNR within
    0.5 dB: default bf16 MLPs and start-t jitter in both probes)."""
    snap = _slab_snapshot(tmp_path)
    results = []
    for make in (lambda: JRenderer(32, 24),
                 lambda: TRenderer(32, 24, device="cpu")):
        r = make()
        with pytest.warns(UserWarning, match="bake fidelity probe"):
            nerf = r.load_nerf(snap, bake=True, bake_resolution=bake_res,
                               feat_resolution=bake_res,
                               verify_threshold_db=thr)
        assert not nerf.flash
        assert (nerf._baked_sigma is None) == (action == "unbaked")
        r.frame()
        assert np.isfinite(r.display_image()).all()
        results.append(nerf)
    jnerf, tnerf = results
    assert tnerf.bake_fidelity[1] == action
    if action == "baked_only":
        # the JAX package keeps no probe result: probe the baked path
        # again on both and compare the scores
        jp, ja = jnerf.verify_bake_fidelity(threshold_db=thr)
        tp, ta = tnerf.verify_bake_fidelity(threshold_db=thr)
        assert ja == ta == "ok"
        assert abs(tp - jp) < 0.5, (tp, jp)

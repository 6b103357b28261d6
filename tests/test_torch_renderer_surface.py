"""The rest of the NerfMeshRenderer and Testbed surface in the PyTorch
port against the JAX package: floaty removal and density-grid dump/load
through the renderer (with frames that show the memoized scene was
rebuilt), the envmap background, the depth overlay and colormaps, the
trajectory recorder, stats(), close(), the nearest-depth merge of two
NeRFs, the Testbed camera helpers, crop box and reset.

Same snapshot files in both packages, float32 MLPs, jitter off.
Tolerances: host-side numpy results exact; viridis, the overlay and the
envmap image 1e-5 on the same inputs, turbo within its float32 rounding
bar (`_turbo_bar`); frames >= 50 dB PSNR as in
tests/test_torch_slice.py; depth buffers 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.renderer import NerfMeshRenderer as JRenderer
from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import colormaps as jcm
from nerf_glasses_tpu.ops import raymarch as jraymarch
from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer as TRenderer
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import colormaps as tcm
from nerf_glasses_tpu_torch.ops import raymarch as traymarch
from nerf_glasses_tpu_torch.utils import meters
from tests.helpers import (make_sphere_density, opaque_params,
                           write_quad_gltf, write_test_snapshot)

torch.set_num_threads(1)

W, H = 32, 24
FAST = {"max_rounds": 96, "init_skip_iters": 24, "jitter": False,
        "compute_dtype": "float32"}


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def _renderers(snap, w=W, h=H):
    out = []
    for r in (JRenderer(w, h), TRenderer(w, h, device="cpu")):
        r.load_nerf(snap).march_overrides = dict(FAST)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def sphere_snapshot(tmp_path_factory):
    p = tmp_path_factory.mktemp("snap") / "sphere.msgpack"
    write_test_snapshot(p)
    return str(p)


@pytest.fixture(scope="module")
def floaty_snapshot(tmp_path_factory):
    """The sphere plus a small opaque blob away from it
    (tests/test_hybrid.py:127-145)."""
    grid = make_sphere_density(radius=0.2, value=0.05)
    grid += make_sphere_density(radius=0.06, value=0.05,
                                center=(0.2, 0.75, 0.5))
    p = tmp_path_factory.mktemp("floaty") / "floaty.msgpack"
    write_test_snapshot(p, density_grid=grid, params=opaque_params())
    return str(p)


# ---------------------------------------------------------------------------
# Floaty removal and density-grid dump / load
# ---------------------------------------------------------------------------

def test_remove_floaties_matches_jax_and_rebuilds_the_scene(floaty_snapshot):
    jr, tr = _renderers(floaty_snapshot)
    frames = {}
    for name, r in (("jax", jr), ("torch", tr)):
        r.frame()
        before = r.display_image()
        r.remove_floaties()
        r.update_model_view_proj()      # restart the accumulation
        r.frame()
        frames[name] = (before, r.display_image())
    occ_j = np.asarray(jr._nerfs[0].occ)
    occ_t = tr._nerfs[0].occ.numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert occ_t[0, 64, 64, 64] == 1            # the sphere stays
    assert occ_t[0, 64, 96, 25] == 0            # the blob is gone
    assert tr._nerfs[0].occ.dtype == torch.uint8
    before, after = frames["torch"]
    # the blob was on screen and is no longer: the cached jump grid of the
    # frame before was not reused
    assert np.abs(after - before).max() > 0.2
    assert psnr(before[..., :3], frames["jax"][0][..., :3]) >= 50.0
    assert psnr(after[..., :3], frames["jax"][1][..., :3]) >= 50.0


def test_remove_floaties_returns_the_cluster_count(floaty_snapshot):
    _, tr = _renderers(floaty_snapshot)
    assert tr.remove_floaties() == 2
    assert tr.removeFloaties.__func__ is TRenderer.remove_floaties


def test_density_grid_dump_load_roundtrip(sphere_snapshot, tmp_path):
    jr, tr = _renderers(sphere_snapshot, 8, 8)
    fj, ft = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jr.dump_density_grid_file(fj)
    tr.dump_density_grid_file(ft)
    assert os.path.getsize(ft) == 8 * 128 ** 3
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    nerf = tr._nerfs[0]
    before = nerf.occ.numpy().copy()
    version = nerf._scene_version
    tr.load_density_grid_file(fj)               # the JAX package's file
    np.testing.assert_array_equal(nerf.occ.numpy(), before)
    assert nerf._scene_version == version + 1
    grid = tr.dump_density_grid()
    assert grid.shape == (8, 128, 128, 128) and grid.dtype == np.uint8
    np.testing.assert_array_equal(grid, np.asarray(jr.dumpDensityGrid()))


def test_load_density_grid_array_invalidates_the_scene(sphere_snapshot):
    jr, tr = _renderers(sphere_snapshot)
    imgs = []
    for r in (jr, tr):
        r.frame()
        full = r.display_image()
        grid = np.array(r.dump_density_grid())
        grid[:, :, :, 64:] = 0                  # cut the sphere in half (x)
        r.load_density_grid_array(grid)
        r.update_model_view_proj()
        r.frame()
        imgs.append((full, r.display_image()))
    (_, half_j), (full_t, half_t) = imgs
    assert np.abs(half_t - full_t).max() > 0.05
    assert psnr(half_t[..., :3], half_j[..., :3]) >= 50.0


# ---------------------------------------------------------------------------
# Envmap, colormaps, depth overlay
# ---------------------------------------------------------------------------

def test_envmap_background_matches_jax(sphere_snapshot, tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    env = rng.integers(0, 256, (8, 16, 3), dtype=np.uint8)
    env[..., 1] |= 128                          # greenish
    path = str(tmp_path / "env.png")
    Image.fromarray(env).save(path)
    jr, tr = _renderers(sphere_snapshot, 16, 12)
    for r in (jr, tr):
        r.orbit(0.7, 0.3, 0)
        r.envmap(path)
        r.frame()
    np.testing.assert_array_equal(tr._background_from_envmap(),
                                  jr._background_from_envmap())
    img_t, img_j = tr.display_image(), jr.display_image()
    assert img_t[0, 0, 1] >= 0.5                # the corner shows the envmap
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        tr.envmap(str(tmp_path / "missing.png"))


def test_camera_rays_equal_jax():
    cam = JRenderer(8, 6)
    cam.orbit(0.4, -0.2, 0.3)
    o_j, d_j = jraymarch.camera_rays(cam.view_projection_mat, 20, 12)
    o_t, d_t = traymarch.camera_rays(cam.view_projection_mat, 20, 12)
    np.testing.assert_array_equal(o_t, o_j)
    np.testing.assert_array_equal(d_t, d_j)


def _turbo_bar(x):
    """The float32 rounding bar of the turbo polynomial at x: each side
    sums six float32 terms k_i x^i (the same powers on both sides) in its
    own order, and XLA's CPU dot may fuse the products and sums into FMAs
    where aten does not, depending on the host CPU. A recursive sum of n
    products lies within gamma_n = n u / (1 - n u) of sum |k_i x^i| from
    the exact value (u = 2^-24), so the two sides lie within twice that
    of each other. The coefficients reach 132 and -153, the terms ~270 at
    x ~ 0.9: there 1e-5 is a third of one ulp of the terms."""
    xc = np.clip(x, 0.0, 1.0).astype(np.float32)
    x2 = xc * xc
    x3 = x2 * xc
    powers = np.stack([np.ones_like(xc), xc, x2, x3, x3 * xc, x3 * x2], -1)
    k = np.concatenate([np.asarray(tcm._TURBO_4, np.float32),
                        np.asarray(tcm._TURBO_2, np.float32)], 1)
    u, n = 2.0 ** -24, k.shape[1]
    return 2.0 * n * u / (1.0 - n * u) * (
        np.abs(powers.astype(np.float64)) @ np.abs(k.astype(np.float64)).T)


@pytest.mark.parametrize("name", ["colormap_turbo", "colormap_viridis"])
def test_colormaps_match_jax(name):
    """Viridis to 1e-5; turbo within its float32 rounding bar
    (`_turbo_bar`); black at and below 0 to 1e-6."""
    x = np.concatenate([np.random.default_rng(0).uniform(-0.2, 1.2, 500),
                        [0.0, 1.0, 0.5]]).astype(np.float32)
    out_j = np.asarray(getattr(jcm, name)(jnp.asarray(x)))
    out_t = getattr(tcm, name)(torch.from_numpy(x)).numpy()
    assert out_t.shape == (len(x), 3)
    if name == "colormap_turbo":
        np.testing.assert_array_less(np.abs(out_t - out_j), _turbo_bar(x))
    else:
        np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(out_t[-3], out_t[x <= 0][0], atol=1e-6)


@pytest.mark.parametrize("colormap", ["turbo", "viridis"])
def test_overlay_depth_matches_jax(colormap):
    rng = np.random.default_rng(1)
    frame = rng.uniform(0, 1, (6, 8, 4)).astype(np.float32)
    depth = rng.uniform(0, 2, (6, 8)).astype(np.float32)
    depth[:2] = 0.0                             # no depth: frame kept
    out_j = np.asarray(jcm.overlay_depth(jnp.asarray(frame),
                                         jnp.asarray(depth), 0.6, 0.4,
                                         colormap))
    out_t = tcm.overlay_depth(torch.from_numpy(frame),
                              torch.from_numpy(depth), 0.6, 0.4,
                              colormap).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_array_equal(out_t[:2], frame[:2])
    np.testing.assert_array_equal(out_t[..., 3], frame[..., 3])


def test_visualize_depth_mode_matches_jax(tmp_path):
    """display_image with the overlay on (tests/test_sampling_colormaps.py:
    87) on an opaque sphere; the overlay colours pixels that have depth."""
    snap = str(tmp_path / "opaque.msgpack")
    write_test_snapshot(snap, params=opaque_params())
    jr, tr = _renderers(snap, 16, 12)
    imgs = []
    for r in (jr, tr):
        r.frame()
        plain = r.display_image()
        r.visualize_depth = True
        r.depth_overlay_scale = 0.5
        imgs.append((plain, r.display_image(), np.asarray(r._depth_buffer)))
    (_, over_j, depth_j), (plain_t, over_t, depth_t) = imgs
    np.testing.assert_allclose(depth_t, depth_j, atol=1e-4)
    has_depth = depth_t > 0
    assert has_depth.any() and not has_depth.all()
    assert np.abs(over_t - plain_t)[has_depth].max() > 0.1
    np.testing.assert_array_equal(over_t[~has_depth], plain_t[~has_depth])
    # the turbo polynomial's slope is under 10: 1e-4 of depth is 1e-3 here
    np.testing.assert_allclose(over_t, over_j, atol=2e-3)


# ---------------------------------------------------------------------------
# Trajectory, stats, close, clear, merge
# ---------------------------------------------------------------------------

def test_record_trajectory_writes_the_same_transforms(sphere_snapshot,
                                                      tmp_path):
    jr, tr = _renderers(sphere_snapshot, 16, 12)
    dj, dt = tmp_path / "j", tmp_path / "t"
    for r, d in ((jr, dj), (tr, dt)):
        d.mkdir()
        r.record_trajectory(num_images=3, out_dir=str(d))
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj))
    assert sum(n.startswith("trajectory_") for n in names) >= 3
    for n in names:
        if n.startswith("transform_"):
            assert (dt / n).read_text() == (dj / n).read_text()
    from PIL import Image
    assert Image.open(dt / "trajectory_1.jpg").size == (16, 12)


def test_stats_have_the_jax_keys(sphere_snapshot):
    jr, tr = _renderers(sphere_snapshot, 16, 12)
    tr.profile = True
    assert tr.frame()
    s = tr.stats()
    assert set(s) == set(jr.stats())
    assert s["frame_count"] == 1 and s["n_nerfs"] == 1 and s["n_meshes"] == 0
    assert s["frame_ms"] > 0.0 and s["nerf_ms"] > 0.0 and s["mesh_ms"] >= 0.0
    assert s["render_path"] == "unbaked"
    assert s["hbm_available"] is False and s["hbm_bytes_in_use"] == 0
    assert meters.device_memory_stats("cpu") == {
        "available": False, "bytes_in_use": 0, "bytes_limit": 0,
        "peak_bytes_in_use": 0}


def test_ema_matches_jax():
    from nerf_glasses_tpu.utils.meters import Ema as JEma
    a, b = JEma("step", 4.0), meters.Ema("step", 4.0)
    for v in (3.0, 1.0, 4.0, 1.0, 5.0):
        a.update(v)
        b.update(v)
        assert b.ema_val == a.ema_val and b.val == a.val
    b.set(2.5)
    assert b.val == b.ema_val == 2.5


def test_close_clear_and_aliases(sphere_snapshot, tmp_path):
    tr = TRenderer(8, 6, device="cpu")
    tr.load_nerf(sphere_snapshot).march_overrides = dict(FAST)
    quad = write_quad_gltf(tmp_path / "q.gltf")
    assert tr.loadMesh(str(quad)) is not None
    assert tr.frame() is True
    tr.clear_meshes()
    tr.clear_nerfs()
    assert tr.stats()["n_nerfs"] == 0 and tr.stats()["render_path"] is None
    assert tr.frame() is True                   # no NeRF: a black frame
    assert tr.display_image().shape == (6, 8, 4)
    tr.close()
    count = tr.stats()["frame_count"]
    assert tr.frame() is False and tr.stats()["frame_count"] == count
    for alias, name in (("loadNerf", "load_nerf"), ("loadMesh", "load_mesh"),
                        ("removeFloaties", "remove_floaties"),
                        ("updateModelViewProj", "update_model_view_proj"),
                        ("dumpDensityGrid", "dump_density_grid")):
        assert getattr(TRenderer, alias) is getattr(TRenderer, name)


def test_multi_nerf_depth_combine_matches_jax(tmp_path):
    """Two opaque spheres, the nearer one loaded second: the merge takes
    the nearer depth (tests/test_misc.py:62)."""
    near, far = str(tmp_path / "near.msgpack"), str(tmp_path / "far.msgpack")
    write_test_snapshot(near, density_grid=make_sphere_density(
        0.15, center=(0.5, 0.5, 0.75)), params=opaque_params())
    write_test_snapshot(far, density_grid=make_sphere_density(
        0.15, center=(0.5, 0.5, 0.25)), params=opaque_params())
    out = []
    for r in (JRenderer(16, 12), TRenderer(16, 12, device="cpu")):
        for path in (far, near):
            r.load_nerf(path).march_overrides = {**FAST, "max_rounds": 32}
        r.frame()
        out.append((np.asarray(r._depth_buffer), r.display_image()))
    (depth_j, img_j), (depth_t, img_t) = out
    assert 1.3 < depth_t[6, 8] < 1.9
    np.testing.assert_allclose(depth_t, depth_j, atol=1e-4)
    assert psnr(img_t[..., :3], img_j[..., :3]) >= 50.0


# ---------------------------------------------------------------------------
# Testbed: camera helpers, crop box, reset
# ---------------------------------------------------------------------------

def _testbeds(snap):
    tj, tt = JTestbed(), TTestbed(device="cpu")
    for tb in (tj, tt):
        tb.load_snapshot(snap)
    return tj, tt


def test_camera_helpers_equal_jax(sphere_snapshot):
    tj, tt = _testbeds(sphere_snapshot)
    rng = np.random.default_rng(2)
    look, direction, rel = (rng.standard_normal(3).astype(np.float32)
                            for _ in range(3))
    for tb in (tj, tt):
        tb.look_at = look
        tb.set_view_dir(direction)
        tb.scale = 2.25
        tb.translate_camera(rel)
        tb.set_fov(37.0)
    np.testing.assert_array_equal(tt.camera_matrix, tj.camera_matrix)
    np.testing.assert_array_equal(tt.look_at, tj.look_at)
    np.testing.assert_array_equal(tt.view_pos, tj.view_pos)
    np.testing.assert_array_equal(tt.view_dir, tj.view_dir)
    np.testing.assert_array_equal(tt.up_dir, tj.up_dir)
    np.testing.assert_array_equal(tt.relative_focal_length,
                                  tj.relative_focal_length)
    assert tt.scale == tj.scale == 2.25
    np.testing.assert_allclose(tt.view_dir,
                               direction / np.linalg.norm(direction),
                               atol=1e-6)


def test_crop_box_equals_jax(sphere_snapshot):
    tj, tt = _testbeds(sphere_snapshot)
    th = 0.3
    m = np.array([[0.3 * np.cos(th), -0.2 * np.sin(th), 0.0, 0.1],
                  [0.3 * np.sin(th), 0.2 * np.cos(th), 0.0, -0.2],
                  [0.0, 0.0, 0.25, 0.05]], np.float32)
    for nerf_space in (True, False):
        for tb in (tj, tt):
            tb.set_crop_box(m, nerf_space)
        np.testing.assert_array_equal(tt.render_aabb.min, tj.render_aabb.min)
        np.testing.assert_array_equal(tt.render_aabb.max, tj.render_aabb.max)
        np.testing.assert_array_equal(tt.render_aabb_to_local,
                                      tj.render_aabb_to_local)
        np.testing.assert_array_equal(tt.crop_box(nerf_space),
                                      tj.crop_box(nerf_space))
        np.testing.assert_allclose(tt.crop_box(nerf_space), m, atol=1e-5)
        for a, b in zip(tt.crop_box_corners(nerf_space),
                        tj.crop_box_corners(nerf_space)):
            np.testing.assert_array_equal(a, b)
    # the rotated crop box changes what renders: the scene key follows it
    tt.march_overrides = dict(FAST)
    tj.march_overrides = dict(FAST)
    img_t = tt.render(W, H, linear=False)
    img_j = tj.render(W, H, linear=False)
    assert psnr(img_t[..., :3], img_j[..., :3]) >= 50.0


def test_reset_and_occ_setter(sphere_snapshot):
    _, tt = _testbeds(sphere_snapshot)
    tt.march_overrides = dict(FAST)
    before = tt.render(16, 12)
    assert before[6, 8, 3] > 0.05 and tt._spp == 0
    version, old_grid = tt._scene_version, tt.net.grid.clone()
    tt.training_step = 7
    tt.reset()
    assert tt.training_step == 0 and not tt.density_grid.any()
    assert int(tt.occ.sum()) == 0 and tt._scene_version > version
    assert not torch.equal(tt.net.grid, old_grid)
    assert tt.net.grid.abs().max() <= 1e-4      # a fresh hash table
    again = TTestbed(device="cpu")
    again.load_snapshot(sphere_snapshot)
    again.reset(reset_density_grid=False)
    assert torch.equal(again.net.grid, tt.net.grid)     # seed 1337
    assert again.density_grid.any()
    # the empty grid renders empty: the memoized scene was rebuilt
    tt.render(16, 12)
    assert not tt._frame_buffer[..., 3].any()
    tt._spp = 3
    tt.reset_accumulation(due_to_camera_movement=True, immediate_redraw=False)
    assert tt._spp == 0

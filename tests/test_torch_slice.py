"""The slice end to end: NerfMeshRenderer.load_nerf + load_mesh + frame()
+ display_image() in the PyTorch port against the JAX package.

Frames are compared by PSNR over the displayed sRGB image, held to
>= 50 dB (the golden test of the JAX package accepts 25 dB between real
renders; the two packages run the same algorithm, float32 MLPs, no
jitter, and differ by summation order and by the JAX package's untiled
CPU mesh pass). Scenes follow tests/test_hybrid.py:74-125 at 64x48.
"""

import os

import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.renderer import NerfMeshRenderer as JRenderer
from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer as TRenderer
from tests.helpers import opaque_params, write_quad_gltf, write_test_snapshot

torch.set_num_threads(1)

W, H = 64, 48
PSNR_DB = 50.0
FAST = {"max_rounds": 96, "init_skip_iters": 24, "jitter": False,
        "compute_dtype": "float32"}
TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "trained", "trained_head_v6.msgpack")


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def _frames(snap, meshes, overrides=FAST, setup=None, n_frames=1,
            load_kw=None):
    """meshes: list of (path, t, s). -> [(jax image, torch image)]."""
    out = []
    for make in (lambda: JRenderer(W, H),
                 lambda: TRenderer(W, H, device="cpu")):
        r = make()
        nerf = r.load_nerf(snap, **(load_kw or {}))
        nerf.march_overrides = dict(overrides)
        for path, t, s in meshes:
            assert r.load_mesh(path, t=t, s=s) is not None
        if setup is not None:
            setup(r, nerf)
        for _ in range(n_frames):
            assert r.frame()
        out.append((r.display_image(), np.asarray(r._frame_buffer)))
    return out


@pytest.fixture(scope="module")
def sphere_snapshot(tmp_path_factory):
    p = tmp_path_factory.mktemp("snap") / "sphere.msgpack"
    write_test_snapshot(p)
    return str(p)


@pytest.fixture(scope="module")
def slab_snapshot(tmp_path_factory):
    grid = np.zeros((1, 128, 128, 128), np.float32)
    grid[0, 64:96] = 1.0      # NGP z in [0.5, 0.75): opaque slab
    p = tmp_path_factory.mktemp("slab") / "slab.msgpack"
    write_test_snapshot(p, density_grid=grid, params=opaque_params())
    return str(p)


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    return str(write_quad_gltf(tmp_path_factory.mktemp("quad") / "q.gltf"))


def test_surface_occludes_nerf(sphere_snapshot, quad):
    (ji, jfb), (ti, tfb) = _frames(sphere_snapshot,
                                   [(quad, [0, 0, 1.2], [40, 40, 1])])
    assert ti.shape == (H, W, 4) and np.isfinite(ti).all()
    assert tfb[..., 3].min() > 0.99
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB


@pytest.mark.parametrize("z", [-0.5, 0.5], ids=["behind", "in_front"])
def test_nerf_occludes_surface(slab_snapshot, quad, z):
    (ji, jfb), (ti, tfb) = _frames(slab_snapshot,
                                   [(quad, [0, 0, z], [40, 40, 1])])
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB
    c = (slice(16, 32), slice(24, 40))
    red = (tfb[..., 0] - tfb[..., 1])[c].mean()
    if z < 0:
        assert abs(red) < 1e-3      # behind the opaque slab: hidden
    else:
        assert red > 0.05


def test_hybrid_frame_progressive(sphere_snapshot, quad):
    """Small quad beside the sphere, three frames accumulated."""
    (ji, _), (ti, _) = _frames(
        sphere_snapshot, [(quad, [0.6, 0.0, 0.8], [0.35, 0.35, 0.35])],
        n_frames=3)
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB


@pytest.mark.parametrize("overrides", [
    {"jitter": False, "compute_dtype": "float32"}, {}],
    ids=["float32", "defaults_bf16_jitter"])
def test_trained_head_with_quad(quad, overrides):
    """trained_head_v6 as the bench places it, two accumulated frames;
    also at the package defaults (bf16 MLPs, start-t jitter), whose
    rounding points the port reproduces."""
    def setup(r, nerf):
        nerf.render_aabb.min = np.array([0.1, 0.1, 0.1], np.float32)
        nerf.render_aabb.max = np.array([0.9, 0.9, 0.9], np.float32)
        r.orbit(0.4, -0.1, 0)
        r.orbit(0, 0, 3.5)

    (ji, jfb), (ti, tfb) = _frames(
        TRAINED, [(quad, [0.0, 0.1, 0.22], [0.2, 0.1, 0.2])],
        overrides=overrides, setup=setup, n_frames=2)
    assert (tfb[..., 3] > 0.5).mean() > 0.02
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB


def test_trained_head_flash_with_quad(quad):
    """trained_head_v6 on the flash path (bake 64^3 here), placed as the
    bench places it, two accumulated frames, float32 MLPs, no jitter."""
    def setup(r, nerf):
        nerf.render_aabb.min = np.array([0.1, 0.1, 0.1], np.float32)
        nerf.render_aabb.max = np.array([0.9, 0.9, 0.9], np.float32)
        r.orbit(0.4, -0.1, 0)
        r.orbit(0, 0, 3.5)

    (ji, jfb), (ti, tfb) = _frames(
        TRAINED, [(quad, [0.0, 0.1, 0.22], [0.2, 0.1, 0.2])],
        overrides={"jitter": False, "compute_dtype": "float32"},
        setup=setup, n_frames=2,
        load_kw=dict(bake=True, bake_resolution=64, feat_resolution=64,
                     verify_fidelity=False))
    assert (tfb[..., 3] > 0.5).mean() > 0.02
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB


def test_load_nerf_bake_matches_jax(sphere_snapshot, quad):
    """load_nerf(bake=True): bake (64^3 sigma and features here) and flash
    on (the fidelity probe is held to the JAX package in
    tests/test_torch_flash.py); then two hybrid frames on the flash path
    with a quad beside the sphere."""
    nerfs = []
    (ji, _), (ti, tfb) = _frames(
        sphere_snapshot, [(quad, [0.6, 0.0, 0.8], [0.35, 0.35, 0.35])],
        setup=lambda r, nerf: nerfs.append(nerf), n_frames=2,
        load_kw=dict(bake=True, bake_resolution=64, feat_resolution=64,
                     verify_fidelity=False))
    jn, tn = nerfs
    assert jn.flash and tn.flash and tn.bake_fidelity is None
    assert jn.last_render_path == tn.last_render_path == "flash"
    assert (tfb[..., 3] > 0.5).mean() > 0.02
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB


def test_testbed_render_spp(sphere_snapshot):
    """Testbed.render: spp accumulation + sRGB tonemap, as render.py
    calls it (python_api.cu:83-111)."""
    from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
    from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
    imgs = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(sphere_snapshot)
        tb.march_overrides = dict(FAST)
        imgs.append(tb.render(40, 24, spp=2, linear=False))
    assert imgs[1].shape == (24, 40, 4)
    assert imgs[1][12, 20, 3] > 0.05
    assert psnr(imgs[1][..., :3], imgs[0][..., :3]) >= PSNR_DB


def test_two_nerfs_nearest_depth_merge(sphere_snapshot, slab_snapshot,
                                       tmp_path):
    """No mesh; two NeRFs merged by nearest depth (combineBuffersKernel,
    nerf_mesh_renderer.cu:34-48); save_frame writes the displayed image."""
    def setup(r, nerf):
        extra = r.load_nerf(slab_snapshot)
        extra.march_overrides = dict(FAST)
        r.orbit(0.3, 0.2, 0)

    (ji, _), (ti, _) = _frames(sphere_snapshot, [], setup=setup, n_frames=2)
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB

    r = TRenderer(W, H, device="cpu")
    r.load_nerf(sphere_snapshot).march_overrides = dict(FAST)
    r.frame()
    out = tmp_path / "frame.png"
    r.save_frame(str(out))
    from PIL import Image
    png = np.asarray(Image.open(out), np.float32) / 255.0
    np.testing.assert_allclose(png, r.display_image()[::-1, :, :3],
                               atol=1.0 / 255 + 1e-6)

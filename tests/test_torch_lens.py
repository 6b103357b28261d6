"""Camera features of the PyTorch port against the JAX package: the lens
models, the trained distortion grid, pixel-centre snapping, depth of
field, the rolling shutter and the flash gate for non-plain cameras.

- utils/lens.py and utils/sampling.py (numpy) equal the JAX package's
  exactly on seeded inputs.
- The traced lens models of ops/raymarch.py (_f_theta_dirs,
  _latlong_dirs, _opencv_undistort, _read_image2) match the JAX
  package's to 1e-6 absolute.
- The five cases of tests/test_lens_render.py, run on both packages
  with the same sphere snapshot (tests/helpers.py, opaque network) at
  64x48, float32 MLPs and jitter off: the port shows the property the
  JAX test asserts, and each port frame is >= 50 dB from the JAX frame.
  Depth of field, f-theta and lat-long are held the same way.
- On a baked Testbed with flash on, a non-plain camera turns the coarse
  init off: last_render_path equals the JAX package's and the frame is
  >= 40 dB from its frame.
"""

import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.io.dataset import ngp_matrix_to_nerf as j_to_nerf
from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.utils import lens as jlens
from nerf_glasses_tpu.utils import sampling as jsampling
from nerf_glasses_tpu_torch.io.dataset import ngp_matrix_to_nerf as t_to_nerf
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.utils import lens as tlens
from nerf_glasses_tpu_torch.utils import sampling as tsampling
from tests.helpers import (make_sphere_density, opaque_params,
                           write_test_snapshot)

torch.set_num_threads(1)

W, H = 64, 48
CFG = JCfg(n_levels=4, log2_hashmap_size=9, base_resolution=4,
           per_level_scale=2.0)
FAST = {"max_rounds": 32, "jitter": False, "compute_dtype": "float32"}
OPENCV = (0.4, 0.1, 0.02, 0.02, 0.0, 0.0, 0.0)
# f-theta: alpha = r1 * |pix| over a 64x48 frame, about 34 degrees at the
# corners
FTHETA = (0.0, 0.015, 0.0, 0.0, 0.0, 64.0, 48.0)


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# numpy utilities
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_UV = _RNG.uniform(-0.6, 0.6, (257, 2))
_DIRS = _RNG.normal(size=(257, 3))
_DIRS /= np.linalg.norm(_DIRS, axis=-1, keepdims=True)
_IDX = np.concatenate([np.arange(64), _RNG.integers(0, 1 << 20, 64)])
_SQ = np.concatenate([_RNG.uniform(-1, 1, (255, 2)), [[0.0, 0.0],
                                                       [0.0, 0.5]]])

NUMPY_CASES = {
    "f_theta_undistortion": lambda m: m.f_theta_undistortion(
        _UV, (0.1, 0.9, -0.2, 0.05, 0.01, 1.7, 1.3)),
    "latlong_to_dir": lambda m: m.latlong_to_dir(_UV + 0.5),
    "dir_to_latlong": lambda m: m.dir_to_latlong(_DIRS),
    "opencv_lens_undistortion": lambda m: m.opencv_lens_undistortion(
        _UV[:, 0], _UV[:, 1], *OPENCV[:4]),
    "halton": lambda m: m.halton(_IDX, 3),
    "halton23": lambda m: m.halton23(_IDX),
    "sobol2d": lambda m: m.sobol2d(_IDX),
    "ld_random_pixel_offset": lambda m: np.stack(
        [m.ld_random_pixel_offset(i) for i in range(16)]),
    "square2disk_shirley": lambda m: m.square2disk_shirley(_SQ),
    "cosine_hemisphere": lambda m: m.cosine_hemisphere(_SQ * 0.5 + 0.5),
}


@pytest.mark.parametrize("name", list(NUMPY_CASES))
def test_numpy_utilities_equal_jax(name):
    mods = ((tlens, jlens) if name in ("f_theta_undistortion",
                                       "latlong_to_dir", "dir_to_latlong",
                                       "opencv_lens_undistortion")
            else (tsampling, jsampling))
    got, want = (NUMPY_CASES[name](m) for m in mods)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Traced lens models
# ---------------------------------------------------------------------------

def _traced(name, m):
    uv = (_UV + 0.5).astype(np.float32).reshape(257, 1, 2)
    if m is jrm:
        import jax.numpy as jnp
        arr = jnp.asarray
    else:
        def arr(a):
            return torch.from_numpy(np.asarray(a, np.float32))
    if name == "f_theta":
        # the first 32 rows fall off the stable range of the polynomial
        p = np.array([0.0, 2.5, 0.0, 0.0, 0.0, 1.3, 1.1], np.float32)
        return m._f_theta_dirs(arr(uv - 0.5), arr(p))
    if name == "latlong":
        return m._latlong_dirs(arr(uv))
    if name == "opencv":
        x, y = m._opencv_undistort(arr(uv[..., 0] * 2 - 1),
                                   arr(uv[..., 1] * 2 - 1),
                                   arr(np.array(OPENCV, np.float32)))
        return np.stack([_np(x), _np(y)], -1)
    grid = np.random.default_rng(1).uniform(-0.1, 0.1, (5, 7, 2))
    return m._read_image2(arr(grid), arr(uv))


@pytest.mark.parametrize("name", ["f_theta", "latlong", "opencv",
                                  "read_image2"])
def test_traced_lens_models_match_jax(name):
    got, want = _np(_traced(name, trm)), _np(_traced(name, jrm))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if name == "f_theta":
        bad = np.all(want == [1000.0, 0.0, 0.0], axis=-1)
        assert 0 < bad.sum() < bad.size
        assert np.array_equal(np.all(got == [1000.0, 0.0, 0.0], axis=-1), bad)


# ---------------------------------------------------------------------------
# Frames: the cases of tests/test_lens_render.py on both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("lens") / "snap.msgpack"
    write_test_snapshot(path, cfg=CFG, params=opaque_params(CFG),
                        density_grid=make_sphere_density(radius=0.25))
    return str(path)


@pytest.fixture(scope="module")
def pair(snapshot):
    """(JAX Testbed, port Testbed) as tests/test_lens_render.py sets its
    Testbed up, with float32 MLPs."""
    out = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(snapshot)
        tb.scale = 0.75
        tb.march_overrides = dict(FAST)
        out.append(tb)
    return out


def _render(tb, spp=1):
    return np.asarray(tb.render(W, H, spp=spp, linear=True))


def _buffers(tb, width, height, sample_index=0):
    return _np(tb.render_frame_buffers(width, height, sample_index)[0])


def _set_lens(tb, mode, params):
    tb.dataset.metadata[0].lens_mode = mode
    tb.dataset.metadata[0].lens_params = params
    tb.nerf.render_with_lens_distortion = mode != "perspective"


def _reset(tb):
    _set_lens(tb, "perspective", (0.0,) * 7)
    tb.distortion_map = None
    tb.snap_to_pixel_centers = False
    tb.aperture_size = 0.0
    tb.focus_z = 1.0


def _both(pair, fn):
    """fn(tb) on each package, the camera features turned off after."""
    out = []
    for tb in pair:
        try:
            out.append(fn(tb))
        finally:
            _reset(tb)
    return out


def test_opencv_lens_distortion(pair):
    base_j, base_t = _both(pair, _render)
    dist_j, dist_t = _both(pair, lambda tb: (_set_lens(tb, "opencv", OPENCV),
                                             _render(tb))[1])
    assert np.abs(dist_t - base_t).max() > 1e-3
    assert psnr(base_t, base_j) >= 50.0
    assert psnr(dist_t, dist_j) >= 50.0, psnr(dist_t, dist_j)


def test_distortion_grid(pair):
    grid = np.zeros((8, 8, 2), np.float32)
    grid[..., 0] = 0.15
    grid[2:5, 3:6, 1] = -0.05

    def render(tb):
        tb.nerf.render_with_lens_distortion = True
        tb.distortion_map = grid
        return _render(tb)

    base_t = _render(pair[1])
    dist_j, dist_t = _both(pair, render)
    assert np.abs(dist_t - base_t).max() > 1e-3
    assert psnr(dist_t, dist_j) >= 50.0, psnr(dist_t, dist_j)


def test_snap_to_pixel_centers(pair):
    def frames(tb, snap):
        tb.snap_to_pixel_centers = snap
        return _buffers(tb, W, H, 0), _buffers(tb, W, H, 3)

    (sj0, sj3), (st0, st3) = _both(pair, lambda tb: frames(tb, True))
    assert np.array_equal(st0, st3)
    (cj0, cj3), (ct0, ct3) = _both(pair, lambda tb: frames(tb, False))
    assert np.abs(ct0 - ct3).max() > 1e-4
    for a, b in ((st0, sj0), (ct0, cj0), (ct3, cj3)):
        assert psnr(a, b) >= 50.0, psnr(a, b)


def test_spp_accumulation_antialiases(pair):
    """The JAX test's criterion on the port (the spp = 8 average beats one
    centred sample on the silhouette against a 3x-supersampled truth),
    and the accumulated alphas agree with the JAX package's."""
    def alpha(tb, width, height, spp, snap):
        tb.snap_to_pixel_centers = snap
        acc = sum(_buffers(tb, width, height, i) for i in range(spp))
        return acc[..., 3] / spp

    res = {}
    for key, args in (("one", (W, H, 1, True)), ("hi", (3 * W, 3 * H, 1, True)),
                      ("multi", (W, H, 8, False))):
        res[key] = _both(pair, lambda tb: alpha(tb, *args))
    for key, (j, t) in res.items():
        assert psnr(t, j) >= 50.0, (key, psnr(t, j))
    one, hi, multi = (res[k][1] for k in ("one", "hi", "multi"))
    gt = hi.reshape(H, 3, W, 3).mean(axis=(1, 3))
    edge = (gt > 0.05) & (gt < 0.95)
    assert edge.sum() > 20
    err_one = np.abs(one[edge] - gt[edge]).mean()
    err_multi = np.abs(multi[edge] - gt[edge]).mean()
    assert err_multi < err_one * 0.7, (err_one, err_multi)


def test_rolling_shutter_interpolates_rows(pair):
    """ray_time = v sweeps the sphere's rows from the end camera to the
    start camera, as in the JAX test; start == end gives the plain
    frame; the shutter frame is >= 50 dB from the JAX package's."""
    jtb, ttb = pair
    start = np.asarray(ttb.camera_matrix, np.float32).copy()
    end = start.copy()
    end[0, 3] += 0.12
    saved = ttb.camera_matrix.copy()
    try:
        ttb.camera_matrix = start
        S = _render(ttb)
        alpha_s = _buffers(ttb, W, H)[..., 3]
        ttb.camera_matrix = end
        E = _render(ttb)
        alpha_e = _buffers(ttb, W, H)[..., 3]
    finally:
        ttb.camera_matrix = saved
    assert np.abs(S - E).max() > 1e-3
    rows = np.nonzero((alpha_s + alpha_e).sum(axis=1) > 0.1)[0]
    r0, r1 = int(rows.min()), int(rows.max()) + 1
    span = r1 - r0
    assert span >= 5, span
    v0, v1 = r0 / H, r1 / H
    rs = np.array([-v0 / (v1 - v0), 0.0, 1.0 / (v1 - v0), 0.0], np.float32)

    def shutter(tb, a, b, conv):
        ds = tb.dataset
        to = (lambda m: conv(m, ds.scale, ds.offset, ds.from_mitsuba))
        return tb.render_with_rolling_shutter(to(a), to(b), rs, W, H, spp=1)

    R = shutter(ttb, start, end, t_to_nerf)
    lo = slice(r0, r0 + max(2, int(0.35 * span)))
    hi = slice(r1 - max(2, int(0.35 * span)), r1)
    assert np.abs(R[lo] - E[lo]).mean() < np.abs(R[lo] - S[lo]).mean()
    assert np.abs(R[hi] - S[hi]).mean() < np.abs(R[hi] - E[hi]).mean()
    A = shutter(ttb, start, start, t_to_nerf)
    assert np.abs(S - A).max() < 1e-4
    assert np.array_equal(ttb.camera_matrix, saved)
    # a random term in the shutter time: the hash of pixel and sample
    rs_rand = np.array([0.2, 0.1, 0.3, 0.4], np.float32)
    for r in (rs, rs_rand):
        want = jtb.render_with_rolling_shutter(
            j_to_nerf(start, jtb.dataset.scale, jtb.dataset.offset,
                      jtb.dataset.from_mitsuba),
            j_to_nerf(end, jtb.dataset.scale, jtb.dataset.offset,
                      jtb.dataset.from_mitsuba), r, W, H, spp=2)
        got = ttb.render_with_rolling_shutter(
            t_to_nerf(start, ttb.dataset.scale, ttb.dataset.offset,
                      ttb.dataset.from_mitsuba),
            t_to_nerf(end, ttb.dataset.scale, ttb.dataset.offset,
                      ttb.dataset.from_mitsuba), r, W, H, spp=2)
        assert psnr(got, want) >= 50.0, psnr(got, want)


def _dof(tb):
    tb.aperture_size = 0.05
    tb.focus_z = 1.0
    return _render(tb, spp=2)


def _ftheta(tb):
    _set_lens(tb, "ftheta", FTHETA)
    return _render(tb)


def _latlong(tb):
    _set_lens(tb, "latlong", (0.0,) * 7)
    return _render(tb)


@pytest.mark.parametrize("name,fn", [("dof", _dof), ("ftheta", _ftheta),
                                     ("latlong", _latlong)])
def test_more_cameras_match_jax(pair, name, fn):
    base_t = _render(pair[1])
    j, t = _both(pair, fn)
    assert np.abs(t - base_t).max() > 1e-3
    assert np.isfinite(t).all()
    assert psnr(t, j) >= 50.0, (name, psnr(t, j))


# ---------------------------------------------------------------------------
# Baked Testbed: a non-plain camera turns the flash coarse init off
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def baked_pair(snapshot):
    out = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(snapshot)
        tb.scale = 0.75
        tb.bake(64)
        tb.flash = True
        tb.march_overrides = dict(FAST)
        out.append(tb)
    return out


def _opencv(tb):
    _set_lens(tb, "opencv", OPENCV)


def _aperture(tb):
    tb.aperture_size = 0.05


@pytest.mark.parametrize("name,setup", [("plain", lambda tb: None),
                                        ("opencv", _opencv),
                                        ("dof", _aperture)])
def test_baked_testbed_flash_gate(baked_pair, capfd, name, setup):
    def render(tb):
        setup(tb)
        return _render(tb), tb.last_render_path

    (fj, path_j), (ft, path_t) = _both(baked_pair, render)
    assert path_t == path_j
    assert path_t == ("flash" if name == "plain"
                      else "baked (flash disabled: non-plain camera)")
    assert psnr(ft, fj) >= 40.0, psnr(ft, fj)
    if name != "plain":
        # the stderr line comes once per Testbed
        assert baked_pair[1]._warned_flash_fallback
        capfd.readouterr()
        _both(baked_pair[1:], render)
        assert "flash coarse init" not in capfd.readouterr().err

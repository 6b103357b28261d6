"""Multi-cascade (aabb_scale > 1) scenes end to end in the PyTorch port
against the JAX package: load, the exact frame, bake and the multi-cascade
flash bundle, the hybrid frame with a mesh, load_nerf(bake=True) with its
fidelity probe, the single-program frame and the density queries, on the
three-cascade snapshot of tests/test_multicascade.py (a sphere in cascade
0, a blob that only cascade 2 reaches, nothing in cascade 1's shell) and
its three cameras; and the single-cascade clearance advance of
tests/test_dist_advance.py.

float32 MLPs and jitter off on both sides. Frames are linear
premultiplied RGBA at 48x48:
- exact: >= 50 dB against the JAX Testbed's frame and the same median
  depth over the opaque pixels (to 1e-4); the empty view's alpha is
  exactly 0;
- baked + flash: >= 40 dB against the JAX package's baked + flash frame
  (both bakes run the density MLP in bfloat16) and >= 30 dB against the
  port's own exact frame (the package's bake-probe threshold);
- the hybrid frame (a quad in front of or behind the cascade-0 sphere)
  >= 50 dB against the JAX NerfMeshRenderer's displayed image.
"random" is the same scene with seeded weights whose density and colour
vary over space, so a sample a step off its JAX position would show.
"""

import jax
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.renderer import NerfMeshRenderer as JRenderer
from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops import triangles as jtri
from nerf_glasses_tpu.ops.network import init_params
from nerf_glasses_tpu.parallel import sharding as jsh
from nerf_glasses_tpu.utils.bbox import BoundingBox
from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer as TRenderer
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops import triangles as ttri
from nerf_glasses_tpu_torch.ops.network import params_from_jax
from nerf_glasses_tpu_torch.parallel import sharding as tsh
from tests.helpers import opaque_params, write_quad_gltf, write_test_snapshot
from tests.test_multicascade import CFG4, make_cascaded_grid
from tests.test_raymarch import CFG, OPTS, zero_params
from tests.test_dist_advance import blob_occ
from tests.test_torch_march import _np_params, _tcfg
from tests.test_torch_sharded import _quad_meshes

torch.set_num_threads(1)

N = 48
FAST = {"max_rounds": 64, "jitter": False, "compute_dtype": "float32"}
PSNR_EXACT, PSNR_FLASH_JAX, PSNR_FLASH_EXACT = 50.0, 40.0, 30.0


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def _cam(x, y, z, eye):
    cam = np.zeros((3, 4), np.float32)
    cam[:, 0], cam[:, 1], cam[:, 2], cam[:, 3] = x, y, z, eye
    return cam


# tests/test_multicascade.py's cameras. "empty" looks along +y through
# cascade 1's empty shell; its matrix there is singular (columns 1 and 2
# are parallel), which the exact path never inverts. The flash splat
# inverts the camera, so the flash cases use "empty_flash", the same eye
# and view direction with an image-plane y axis along -z, narrow enough to
# pass beside the outer blob.
CAMS = {
    "centre_sphere": _cam([0.4, 0, 0], [0, -0.4, 0], [0, 0, 1], [0, 0, -1.6]),
    "outer_blob": _cam([0.4, 0, 0], [0, -0.4, 0], [0, 0, -1], [0, 0, 3.0]),
    "empty": _cam([0.3, 0, 0], [0, -0.3, 0], [0, 1, 0], [0.5, -1.4, 0.9]),
    "empty_flash": _cam([0.1, 0, 0], [0, 0, -0.1], [0, 1, 0],
                        [0.5, -1.4, 0.9]),
}


def _random_params():
    p = init_params(jax.random.PRNGKey(11), CFG4)
    return {**p, "grid": p["grid"] * 1e4}


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    d = tmp_path_factory.mktemp("casc")
    out = {}
    for kind, params in (("opaque", opaque_params(CFG4)),
                         ("random", _random_params())):
        out[kind] = str(d / f"{kind}.msgpack")
        write_test_snapshot(out[kind], cfg=CFG4, params=params,
                            density_grid=make_cascaded_grid(),
                            render_aabb=BoundingBox([-1.5] * 3, [2.5] * 3))
    return out


def _load(path):
    j, t = JTestbed(), TTestbed(device="cpu")
    for tb in (j, t):
        tb.load_snapshot(path)
        tb.march_overrides = dict(FAST)
    return j, t


@pytest.fixture(scope="module")
def pairs(snaps):
    return {kind: _load(path) for kind, path in snaps.items()}


@pytest.fixture(scope="module")
def baked(snaps):
    j, t = _load(snaps["opaque"])
    for tb in (j, t):
        tb.bake(128)
        tb.flash = True
    return j, t


def _frame(tb, cam):
    tb.camera_matrix = cam
    frame, depth = tb.render_frame_buffers(N, N)
    return np.asarray(frame), np.asarray(depth)


# ---------------------------------------------------------------------------
# Load and options
# ---------------------------------------------------------------------------

def test_loads_three_cascades(pairs):
    j, t = pairs["opaque"]
    assert t.config.aabb_scale == 4 and t.config.max_cascade == 2
    assert t.density_grid.shape[0] == 3
    assert np.allclose(t.aabb.min, -1.5) and np.allclose(t.aabb.max, 2.5)
    assert t._cone_angle == pytest.approx(1.0 / 256.0)
    np.testing.assert_array_equal(t.occ.numpy(), np.asarray(j.occ))
    scene = t._scene()
    assert "dist" not in scene and scene["dist_mips"].shape == (3, 128, 128,
                                                                128)
    np.testing.assert_array_equal(scene["dist_mips"].numpy(),
                                  np.asarray(j._scene()["dist_mips"]))


def test_march_options_of_every_multicascade_path(baked, pairs):
    """dist_advance on every path, exact included; the flash bundle is the
    JAX package's, with the per-sample occupancy gate left on."""
    _, t = pairs["opaque"]
    exact = t._march_options()
    assert exact.dist_advance and not exact.use_baked_sigma
    j, t = baked
    jo, to = j._march_options(), t._march_options()
    for f in trm.MarchOptions.__dataclass_fields__:
        if f != "config":
            assert getattr(to, f) == getattr(jo, f), f
    assert to.dist_advance and to.vector_occ_gate and to.deferred_color
    assert (to.steps_per_round, to.chunk, to.lowres_factor,
            to.advance_iters) == (16, 1 << 11, 8, 24)
    t.flash = False
    try:
        o = t._march_options()
        assert o.dist_advance and o.use_baked_sigma and not o.vector_rounds
    finally:
        t.flash = True


# ---------------------------------------------------------------------------
# Exact frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,view", [
    ("opaque", "centre_sphere"), ("opaque", "outer_blob"),
    ("opaque", "empty"), ("random", "centre_sphere"),
    ("random", "outer_blob")])
def test_exact_frame_matches_jax(pairs, kind, view):
    j, t = pairs[kind]
    jf, jd = _frame(j, CAMS[view])
    tf, td = _frame(t, CAMS[view])
    assert tf.shape == (N, N, 4) and np.isfinite(tf).all()
    assert t.last_render_path == "unbaked"
    if view == "empty":
        assert tf[..., 3].max() == 0.0 and jf[..., 3].max() == 0.0
        return
    assert psnr(tf, jf) >= PSNR_EXACT, psnr(tf, jf)
    if kind == "opaque":
        a = tf[..., 3]
        assert a.max() > 0.9
        ys, xs = np.nonzero(a > 0.5)
        assert abs(ys.mean() - N / 2) < 8 and abs(xs.mean() - N / 2) < 8
        hit = (a > 0.9) & (jf[..., 3] > 0.9)
        want = 1.4 if view == "centre_sphere" else 1.2
        assert abs(np.median(td[hit]) - want) < 0.2
        assert abs(np.median(td[hit]) - np.median(jd[hit])) < 1e-4
    else:
        assert tf[..., 3].max() > 0.05 and np.ptp(tf[..., :3]) > 0.01
    np.testing.assert_allclose(td, jd, atol=1e-3)


def test_exact_frame_without_the_clearance_hops_matches_jax(pairs):
    """dist_advance forced off: the per-mip voxel DDA serves every probe,
    in both packages alike (the walk the Testbed no longer takes by
    default; JAX models/testbed.py:374-387 says why)."""
    j, t = pairs["opaque"]
    frames = []
    for tb in (j, t):
        tb.march_overrides = {**FAST, "dist_advance": False}
        try:
            frames.append(_frame(tb, CAMS["centre_sphere"])[0])
        finally:
            tb.march_overrides = dict(FAST)
    assert psnr(frames[1], frames[0]) >= PSNR_EXACT


@pytest.mark.parametrize("override", [{"rounds_per_epoch": 2},
                                      {"min_mip": 1},
                                      {"rounds_per_epoch": 4,
                                       "max_rounds": 8}],
                         ids=["two_rounds_an_epoch", "min_mip_1",
                              "epoch_budget"])
def test_new_options_match_jax(pairs, override):
    j, t = pairs["random"]
    frames = []
    for tb in (j, t):
        tb.march_overrides = {**FAST, **override}
        try:
            frames.append(_frame(tb, CAMS["centre_sphere"])[0])
        finally:
            tb.march_overrides = dict(FAST)
    assert frames[1][..., 3].max() > 0.05
    assert psnr(frames[1], frames[0]) >= PSNR_EXACT
    if "max_rounds" in override:
        # 8 rounds in epochs of 4: two epochs, then the march stops
        assert t.last_march_epochs == 2


# ---------------------------------------------------------------------------
# Bake and the multi-cascade flash bundle
# ---------------------------------------------------------------------------

def test_bake_makes_one_grid_per_cascade(baked):
    j, t = baked
    assert t._baked_sigma.shape == (3, 128, 128, 128)
    assert t._baked_feat.shape == (3 * 128 ** 3, 16)
    assert t._baked_feat.dtype == torch.bfloat16 and t._baked_sigma_log
    scene = t._scene()
    js = j._scene()
    np.testing.assert_allclose(scene["occ_pts"].numpy(),
                               np.asarray(js["occ_pts"]), atol=1e-6)
    np.testing.assert_array_equal(scene["occ_pts_pad"].numpy(),
                                  np.asarray(js["occ_pts_pad"]))
    # cascade 2's points reach outside the unit cube
    assert scene["occ_pts"].max() > 2.0 and scene["occ_pts_pad"].max() > 0.02


@pytest.mark.parametrize("view", ["centre_sphere", "outer_blob",
                                  "empty_flash"])
def test_flash_frame_matches_jax_and_exact(baked, pairs, view):
    j, t = baked
    jf, _ = _frame(j, CAMS[view])
    tf, _ = _frame(t, CAMS[view])
    assert t.last_render_path == j.last_render_path == "flash"
    assert np.isfinite(tf).all()
    assert psnr(tf, jf) >= PSNR_FLASH_JAX, psnr(tf, jf)
    exact, _ = _frame(pairs["opaque"][1], CAMS[view])
    assert psnr(tf, exact) >= PSNR_FLASH_EXACT, psnr(tf, exact)
    if view == "empty_flash":
        assert tf[..., 3].max() == 0.0 and exact[..., 3].max() == 0.0
    else:
        assert tf[..., 3].max() > 0.9


@pytest.mark.parametrize("mode", ["baked_sigcolor", "deferred",
                                  "flash_featcolor"])
def test_other_baked_paths_match_jax(baked, mode):
    """Baked sigma with per-sample network colour, deferred shading
    without flash, and the flash bundle with per-sample feature colour."""
    j, t = baked
    frames = []
    for tb in baked:
        saved = dict(tb.march_overrides)
        tb.flash = mode == "flash_featcolor"
        tb.deferred_shading = mode == "deferred"
        if mode == "flash_featcolor":
            tb.march_overrides = {**saved, "deferred_color": False,
                                  "feat_color": True}
        try:
            frames.append(_frame(tb, CAMS["centre_sphere"])[0])
            frames.append(_frame(tb, CAMS["outer_blob"])[0])
        finally:
            tb.flash, tb.deferred_shading = True, False
            tb.march_overrides = saved
    for jf, tf in zip(frames[:2], frames[2:]):
        assert tf[..., 3].max() > 0.9
        assert psnr(tf, jf) >= PSNR_FLASH_JAX, psnr(tf, jf)


def test_fidelity_probe_adopt_and_unbake(baked, snaps):
    j, t = baked
    cam = CAMS["centre_sphere"]
    jp, ja = j.verify_bake_fidelity(64, 64, camera=cam)
    tp, ta = t.verify_bake_fidelity(64, 64, camera=cam)
    assert ja == ta == "ok" and tp >= 30.0
    assert abs(tp - jp) < 0.5, (tp, jp)     # bf16 MLPs and jitter in both
    assert t.flash and t._baked_sigma is not None
    other = TTestbed(device="cpu")
    other.load_snapshot(snaps["opaque"])
    other.march_overrides = dict(FAST)
    other.adopt_bake(t)
    other.flash = True
    assert other._baked_sigma is t._baked_sigma
    np.testing.assert_array_equal(_frame(other, cam)[0], _frame(t, cam)[0])
    assert other.last_render_path == "flash"
    other.unbake()
    exact, _ = _frame(other, cam)
    assert other.last_render_path == "unbaked"
    assert "sigma" not in other._scene() and "occ_pts" not in other._scene()
    assert psnr(exact, _frame(t, cam)[0]) >= PSNR_FLASH_EXACT


# ---------------------------------------------------------------------------
# The renderer: hybrid frames, load_nerf(bake=True), the single program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    return str(write_quad_gltf(tmp_path_factory.mktemp("quad") / "q.gltf"))


def _renderers(snap, quad, z, **load_kw):
    out = []
    for make in (lambda: JRenderer(64, 48),
                 lambda: TRenderer(64, 48, device="cpu")):
        r = make()
        nerf = r.load_nerf(snap, **load_kw)
        nerf.march_overrides = dict(FAST)
        # the renderer's camera stands at NGP z = 2.5 and looks down -z,
        # right behind the outer blob: crop the blob away, so that the
        # rays cross cascades 2 and 1 to the sphere
        nerf.render_aabb.max = np.array([2.5, 2.5, 1.6], np.float32)
        assert r.load_mesh(quad, t=[0.0, 0.0, z], s=[0.9, 0.9, 1.0])
        assert r.frame()
        out.append((r, nerf))
    return out


@pytest.mark.parametrize("z", [0.5, -0.5], ids=["in_front", "behind"])
def test_hybrid_frame_matches_jax(snaps, quad, z):
    """A quad larger than the sphere's silhouette, between the eye and the
    cascade-0 sphere or behind it."""
    (jr, jn), (tr, tn) = _renderers(snaps["opaque"], quad, z)
    ti, ji = tr.display_image(), jr.display_image()
    assert np.isfinite(ti).all() and tn.last_render_path == "unbaked"
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_EXACT
    fb = np.asarray(tr._frame_buffer)
    red = (fb[..., 0] - fb[..., 1])
    assert red.max() > 0.3                      # the quad shows
    centre = red[22:26, 30:34].mean()      # inside the sphere's disc
    assert centre > 0.3 if z > 0 else abs(centre) < 1e-3


def test_load_nerf_bake_on_a_multicascade_snapshot(snaps, quad):
    (jr, jn), (tr, tn) = _renderers(
        snaps["opaque"], quad, -0.5, bake=True, bake_resolution=128,
        feat_resolution=64)
    assert tn.flash and tn.bake_fidelity[1] == "ok"
    assert tn.bake_fidelity[0] >= 30.0
    assert tn._baked_sigma.shape == (3, 128, 128, 128)
    assert tn._baked_feat.shape == (3 * 64 ** 3, 16)
    assert tn.last_render_path == jn.last_render_path == "flash"
    ti, ji = tr.display_image(), jr.display_image()
    assert np.isfinite(ti).all()
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_FLASH_JAX


def test_single_program_frame_matches_jax(baked, tmp_path):
    """render_hybrid_sharded with the multi-cascade Testbed's own scene
    and flash options (the padded splat, the clearance pyramid and the
    grids per cascade ride in the scene)."""
    j, t = baked
    jg, tg = _quad_meshes(tmp_path)
    jm, tm = jtri.build_mesh_arrays([jg]), ttri.build_mesh_arrays([tg])
    xf, nm = ttri.instance_transforms(tm, [tg])
    cam = CAMS["centre_sphere"]
    jf, jd = jsh.render_hybrid_sharded(
        j.params, j._scene(), jm, xf, nm, cam, 64, 32, j._march_options(),
        jsh.make_mesh(1))
    frames = [tsh.render_hybrid_sharded(
        t.net, t._scene(), tm, xf, nm, cam, 64, 32, t._march_options(),
        n_shards=n) for n in (1, 4)]
    tf, td = frames[0]
    assert tf[..., 3].max() > 0.9 and np.isfinite(tf).all()
    assert psnr(tf, jf) >= PSNR_FLASH_JAX, psnr(tf, jf)
    np.testing.assert_allclose(frames[1][0], tf, atol=1e-6)
    np.testing.assert_allclose(frames[1][1], td, atol=1e-6)


# ---------------------------------------------------------------------------
# Density queries on several cascades
# ---------------------------------------------------------------------------

def _query_points(seed=0, n=192):
    """Points in and around the sphere, in and around the outer blob, and
    in cascade 1's empty shell."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.4, 2.4, (n, 3)).astype(np.float32)
    pts[: n // 3] = rng.uniform(0.25, 0.75, (n // 3, 3))
    pts[n // 3: 2 * n // 3] = (np.array([0.5, 0.5, 2.0])
                               + rng.uniform(-0.4, 0.4, (n // 3, 3)))
    return pts.astype(np.float32)


def test_density_and_alpha_queries_match_jax(pairs):
    """Positions are normalised by the training box [-1.5, 2.5]^3 before
    the network, and the occupancy gate reads the position's mip."""
    j, t = pairs["random"]
    pts = _query_points()
    dj, dt = np.asarray(j.density_at(pts)), t.density_at(pts)
    np.testing.assert_allclose(dt, dj, rtol=2e-2, atol=1e-3)   # bf16 MLP
    assert np.ptp(dj) > 0.1
    aj, at = np.asarray(j.alpha_at(pts)), t.alpha_at(pts)
    assert (aj > 0).sum() > 10 and (aj == 0).sum() > 10
    np.testing.assert_array_equal(at > 0, aj > 0)
    np.testing.assert_allclose(at, aj, atol=1e-3)


@pytest.mark.parametrize("direction", [[0.0, -1.0, 0.0], [0.1, -0.2, -1.0]],
                         ids=["down", "toward_the_sphere"])
def test_collide_distances_match_jax(pairs, direction):
    j, t = pairs["opaque"]
    pts = _query_points(1, 96)
    pts[-24:] = np.array([0.5, 0.5, 1.6]) + np.random.default_rng(2).uniform(
        -0.15, 0.15, (24, 3))       # between the blob and the sphere
    d = np.asarray(direction, np.float32)
    dj = np.asarray(j.collide_distances(pts, d))
    dt = t.collide_distances(pts.astype(np.float32), d)
    assert (dj > 0).sum() > 5 and (dj == 0).sum() > 5
    np.testing.assert_array_equal(dt > 0, dj > 0)
    np.testing.assert_allclose(dt, dj, atol=1e-4)


# ---------------------------------------------------------------------------
# The single-cascade clearance advance (tests/test_dist_advance.py)
# ---------------------------------------------------------------------------

def test_dist_advance_matches_jump_advance_frame():
    """Distance-stepped marching settles at the same first occupied
    sample as the jump grid: the frames agree with each other to 1e-5 as
    in the JAX test, and each with its JAX frame."""
    import dataclasses
    import jax.numpy as jnp
    params = zero_params()
    occ = blob_occ()
    box = (np.zeros(3), np.ones(3), np.eye(3), np.zeros(3), np.ones(3))
    js, ts = jrm.make_scene(occ, *box), trm.make_scene(occ, *box)
    js["dist"] = jocc.build_dist_grid(js["occ"])
    ts["dist"] = tocc.build_dist_grid(ts["occ"])
    n = 256
    rng = np.random.default_rng(1)
    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (n, 1))
    o[:, :2] += rng.uniform(-0.4, 0.4, (n, 2)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    surf = np.zeros((n, 4), np.float32)
    tsurf = np.zeros((n,), np.float32)
    surf[::7] = [0.8, 0.1, 0.1, 1.0]    # exercise park-at-surface
    tsurf[::7] = 1.6
    net = params_from_jax(_np_params(params), _tcfg(CFG))
    jbase = dataclasses.replace(OPTS, chunk=64, rounds_per_epoch=2)
    tbase = trm.MarchOptions(config=_tcfg(CFG), **{
        f: getattr(jbase, f) for f in trm.MarchOptions.__dataclass_fields__
        if f != "config"})
    out = {}
    for dist in (False, True):
        jout = jrm.march_frame(
            params, js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(surf),
            jnp.asarray(tsurf), dataclasses.replace(jbase, dist_advance=dist))
        tout, _ = trm.march_frame_impl(
            net, ts, torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(surf), torch.as_tensor(tsurf),
            dataclasses.replace(tbase, dist_advance=dist))
        for k in ("rgba", "depth"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       atol=1e-5)
        out[dist] = tout
    assert out[True]["rgba"][:, 3].max() > 0.1
    for k in ("rgba", "depth"):
        np.testing.assert_allclose(out[True][k].numpy(), out[False][k].numpy(),
                                   atol=1e-5)


def test_dist_advance_flash_render_matches(tmp_path):
    """The flash path through the Testbed with dist_advance toggled: the
    single-cascade scene carries scene["dist"], the frames agree to 1e-4
    as in the JAX test, and with the JAX package's."""
    snap = tmp_path / "s.msgpack"
    write_test_snapshot(snap, params=opaque_params(sigma_raw=6.0))
    imgs = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(str(snap))
        tb.march_overrides = {"jitter": False, "compute_dtype": "float32"}
        tb.bake(64)
        tb.flash = True
        ref = np.asarray(tb.render(32, 32, spp=1, linear=True))
        tb.march_overrides = {**tb.march_overrides, "dist_advance": True}
        assert tb._march_options().dist_advance
        imgs.append((ref, np.asarray(tb.render(32, 32, spp=1, linear=True))))
    assert "dist" in tb._scene() and "dist_mips" not in tb._scene()
    (jref, jdist), (tref, tdist) = imgs
    assert np.isfinite(tdist).all() and tdist[..., 3].max() > 0.9
    np.testing.assert_allclose(tdist, tref, atol=1e-4)
    np.testing.assert_allclose(tdist, jdist, atol=1e-4)

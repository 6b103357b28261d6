"""March parity: the port's exact march against the JAX package, and both
against analytic volume rendering.

The test_raymarch.py cases go through render_image with a near-
orthographic camera (rays within 1e-3 rad of +z through the unit cube):
with all-zero MLP weights the volume has density 1 and colour 0.5, so
alpha(L) = 1 - exp(-L). Port against JAX: atol 1e-5 (float32 MLPs, no
jitter; the two differ only in summation order). Against the closed
forms: the tolerances of test_raymarch.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops.network import init_params
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops.network import params_from_jax
from tests.helpers import make_sphere_density, opaque_params

torch.set_num_threads(1)

JC = JCfg(n_levels=4, log2_hashmap_size=7, base_resolution=4,
          per_level_scale=2.0)
W, H = 8, 6
CAM = np.array([[1e-3, 0.0, 0.0, 0.0],
                [0.0, 1e-3, 0.0, 0.0],
                [0.0, 0.0, 1.0, -1.5]], np.float32)   # origin (.5, .5, -1)


def _tcfg(jc):
    return TCfg(**{f: getattr(jc, f) for f in TCfg.__dataclass_fields__})


def _np_params(p):
    return {k: (tuple(np.asarray(w) for w in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in p.items()}


def _zero_params(cfg):
    p = init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(jnp.zeros_like, p)


def _render_both(params, occ, cfg, surf=None, t_surf=None, **opts):
    opts = {"jitter": False, "compute_dtype": "float32", **opts}
    js = jrm.make_scene(occ, np.zeros(3), np.ones(3), np.eye(3), np.zeros(3),
                        np.ones(3))
    jo = jrm.MarchOptions(config=cfg, **opts)
    j_rgba, j_depth = jrm.render_image(
        params, js, CAM, W, H, jo,
        None if surf is None else jnp.asarray(surf),
        None if t_surf is None else jnp.asarray(t_surf), linear_colors=True)
    tc = _tcfg(cfg)
    ts = trm.make_scene(occ, np.zeros(3), np.ones(3), np.eye(3), np.zeros(3),
                        np.ones(3))
    to = trm.MarchOptions(config=tc, **opts)
    t_rgba, t_depth = trm.render_image(
        params_from_jax(_np_params(params), tc), ts, CAM, W, H, to,
        None if surf is None else torch.as_tensor(surf),
        None if t_surf is None else torch.as_tensor(t_surf),
        linear_colors=True)
    np.testing.assert_allclose(t_rgba, j_rgba, atol=1e-5)
    np.testing.assert_allclose(t_depth, j_depth, atol=1e-5)
    return t_rgba.reshape(-1, 4), t_depth.reshape(-1)


def _occ(full):
    return (np.ones if full else np.zeros)((8, 128, 128, 128), np.uint8)


def _surface(rgba, t):
    return (np.tile(np.asarray([rgba], np.float32), (W * H, 1)),
            np.full((W * H,), t, np.float32))


def test_constant_density_beer_lambert():
    rgba, depth = _render_both(_zero_params(JC), _occ(True), JC)
    a = 1.0 - math.exp(-1.0)
    np.testing.assert_allclose(rgba[:, 3], a, atol=0.01)
    np.testing.assert_allclose(rgba[:, 0], 0.5 * a, atol=0.01)
    np.testing.assert_allclose(depth, 1.0, atol=0.02)


def test_empty_space_is_transparent():
    rgba, _ = _render_both(_zero_params(JC), _occ(False), JC)
    np.testing.assert_allclose(rgba, 0.0, atol=1e-6)


def test_surface_only_composites_surface():
    surf, ts = _surface([0.9, 0.2, 0.1, 1.0], 1.5)
    rgba, _ = _render_both(_zero_params(JC), _occ(False), JC, surf, ts)
    np.testing.assert_allclose(rgba, surf, atol=1e-5)


def test_opaque_surface_gates_volume():
    """The march stops at an opaque surface and blends it with the
    remaining transmittance (testbed.cu:600-607, 886-897)."""
    surf, ts = _surface([1.0, 0.0, 0.0, 1.0], 1.4)
    rgba, _ = _render_both(_zero_params(JC), _occ(True), JC, surf, ts)
    a = 1.0 - math.exp(-0.4)
    np.testing.assert_allclose(rgba[:, 3], 1.0, atol=0.01)
    np.testing.assert_allclose(rgba[:, 0], 0.5 * a + (1 - a), atol=0.02)
    np.testing.assert_allclose(rgba[:, 1], 0.5 * a, atol=0.02)


def test_volume_occludes_surface():
    """A dense volume in front of the surface hides it."""
    surf, ts = _surface([1.0, 0.0, 0.0, 1.0], 1.9)
    rgba, _ = _render_both(opaque_params(JC, sigma_raw=4.6), _occ(True), JC,
                           surf, ts)
    np.testing.assert_allclose(rgba[:, 3], 1.0, atol=0.01)
    np.testing.assert_allclose(rgba[:, 0], rgba[:, 1], atol=1e-3)


def test_partial_surface_blended_in_march():
    surf, ts = _surface([1.0, 1.0, 1.0, 0.5], 1.4)
    rgba, _ = _render_both(_zero_params(JC), _occ(True), JC, surf, ts)
    a1 = 1.0 - math.exp(-0.4)
    assert (rgba[:, 3] > a1 + 0.5 * (1.0 - a1) - 0.02).all()
    assert (rgba[:, 3] <= 1.0 + 1e-5).all()


def test_sphere_multicascade_cone_stepping():
    """aabb_scale 2: cone stepping and the per-mip occupancy probe."""
    cfg = JCfg(n_levels=4, log2_hashmap_size=11, base_resolution=16,
               per_level_scale=1.5, aabb_scale=2)
    grid = np.tile(make_sphere_density(radius=0.2, value=1.0), (2, 1, 1, 1))
    occ = np.asarray(jocc.build_occupancy(jnp.asarray(grid), 1))
    rgba, _ = _render_both(opaque_params(cfg, sigma_raw=2.0), occ, cfg,
                           cone_angle=1.0 / 256, max_rounds=128)
    assert rgba[:, 3].max() > 0.5


def test_hash_u32_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    np.testing.assert_array_equal(
        trm._hash_u32(torch.as_tensor(x.astype(np.int64))).numpy(),
        np.asarray(jrm._hash_u32(jnp.asarray(x))))


@pytest.mark.parametrize("cone", [0.0, 1.0 / 256])
def test_init_rays_jitter(cone):
    cfg = JCfg(aabb_scale=2 if cone else 1)
    rng = np.random.default_rng(1)
    n = 2000
    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (n, 1))
    d = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_surf = np.where(rng.uniform(size=n) < 0.3, 1.7, 0.0).astype(np.float32)
    grid = np.tile(make_sphere_density(radius=0.2, value=1.0),
                   (cfg.max_cascade + 1, 1, 1, 1))
    occ = np.asarray(jocc.build_occupancy(jnp.asarray(grid), cfg.max_cascade))
    box = (np.zeros(3), np.ones(3), np.eye(3), np.zeros(3), np.ones(3))
    jt, jts, ja = jrm.init_rays(
        jrm.make_scene(occ, *box), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_surf), None,
        jrm.MarchOptions(config=cfg, cone_angle=cone), sample_index=7)
    tt, tts, ta = trm.init_rays(
        trm.make_scene(occ, *box), torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(t_surf),
        trm.MarchOptions(config=_tcfg(cfg), cone_angle=cone), sample_index=7)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(tts.numpy(), np.asarray(jts), rtol=1e-6)


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("cone", [0.0, 1.0 / 256])
def test_occupancy_helpers(cone):
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.6, 1.6, (4096, 3)).astype(np.float32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d[:7, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0, 2, 4096).astype(np.float32)
    occ = (rng.uniform(size=(8, 128, 128, 128)) < 0.3).astype(np.uint8)
    for mc in (0, 3):
        np.testing.assert_array_equal(
            tocc.mip_from_pos(T(pos), mc).numpy(),
            np.asarray(jocc.mip_from_pos(J(pos), mc)))
        dt = np.asarray(jocc.calc_dt(J(t), cone))
        np.testing.assert_allclose(tocc.calc_dt(T(t), cone).numpy(), dt)
        mip = np.asarray(jocc.mip_from_dt(J(dt), J(pos), mc))
        np.testing.assert_array_equal(
            tocc.mip_from_dt(T(dt), T(pos), mc).numpy(), mip)
        np.testing.assert_array_equal(
            tocc.occupied_at(T(occ), T(pos), T(mip)).numpy(),
            np.asarray(jocc.occupied_at(J(occ), J(pos), J(mip))))
    res = rng.choice([8.0, 32.0, 128.0], 4096).astype(np.float32)
    np.testing.assert_allclose(
        tocc.advance_to_next_voxel(T(t), cone, T(pos), T(d), 1.0 / T(d),
                                   T(res)).numpy(),
        np.asarray(jocc.advance_to_next_voxel(J(t), cone, J(pos), J(d),
                                              1.0 / J(d), J(res))),
        rtol=1e-6)
    skip = jocc.build_skip_grid(J(occ))
    np.testing.assert_array_equal(tocc.build_skip_grid(T(occ)).numpy(),
                                  np.asarray(skip))
    np.testing.assert_array_equal(
        tocc.skip_level_at(T(np.asarray(skip)), T(pos)).numpy(),
        np.asarray(jocc.skip_level_at(skip, J(pos))))

"""Placement maths and quaternion helpers of the PyTorch port against the
JAX package's: both are numpy on the host, so every function is held
exactly on seeded inputs."""

import numpy as np
import pytest

from nerf_glasses_tpu.utils import placement as jpl
from nerf_glasses_tpu.utils import quat as jquat
from nerf_glasses_tpu_torch.utils import placement as tpl
from nerf_glasses_tpu_torch.utils import quat as tquat
from nerf_glasses_tpu_torch.utils.camera import OrbitCamera

SEEDS = [0, 1, 2]


def _rotations(rng, n):
    qs = rng.standard_normal((n, 4))
    return [jquat.quat_to_mat3(q) for q in qs]


def test_constants_equal():
    assert tpl.LANDMARK_IDS == jpl.LANDMARK_IDS
    assert tpl.LANDMARK_ORDER == jpl.LANDMARK_ORDER


def test_quat_function_set_matches_jax():
    names = [n for n in dir(jquat) if n.startswith("quat_")]
    assert len(names) == 6
    for n in names:
        assert callable(getattr(tquat, n)), n


@pytest.mark.parametrize("seed", SEEDS)
def test_quat_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal(4), rng.standard_normal(4)
    axis, angle = rng.standard_normal(3), float(rng.uniform(-3, 3))
    np.testing.assert_array_equal(tquat.quat_identity(), jquat.quat_identity())
    np.testing.assert_array_equal(tquat.quat_normalize(a),
                                  jquat.quat_normalize(a))
    np.testing.assert_array_equal(tquat.quat_multiply(a, b),
                                  jquat.quat_multiply(a, b))
    np.testing.assert_array_equal(tquat.quat_from_axis_angle(axis, angle),
                                  jquat.quat_from_axis_angle(axis, angle))
    np.testing.assert_array_equal(tquat.quat_to_mat3(a), jquat.quat_to_mat3(a))
    # every branch of Shepperd's method: trace > 0 and each largest diagonal
    mats = _rotations(rng, 40)
    branches = set()
    for m in mats:
        branches.add("trace" if np.trace(m) > 0 else int(np.argmax(np.diag(m))))
        q = tquat.quat_from_mat3(m)
        np.testing.assert_array_equal(q, jquat.quat_from_mat3(m))
        np.testing.assert_allclose(tquat.quat_to_mat3(q), m, atol=1e-12)
    assert branches == {"trace", 0, 1, 2}


@pytest.mark.parametrize("seed", SEEDS)
def test_alignment_equals_jax(seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((30, 3))
    R = _rotations(rng, 1)[0]
    K = P @ R.T + rng.standard_normal(3)
    np.testing.assert_array_equal(tpl.align_point_sets(P, K),
                                  jpl.align_point_sets(P, K))
    np.testing.assert_array_equal(tpl.kabsch_quaternion(list(P), list(K)),
                                  jpl.kabsch_quaternion(list(P), list(K)))
    # the reflection fix: a mirrored target
    Km = K * np.array([1.0, 1.0, -1.0])
    np.testing.assert_array_equal(tpl.kabsch_quaternion(list(P), list(Km)),
                                  jpl.kabsch_quaternion(list(P), list(Km)))
    az_t, po_t = tpl.estimate_face_orientation(P, K)
    az_j, po_j = jpl.estimate_face_orientation(P, K)
    assert az_t == az_j and po_t == po_j


@pytest.mark.parametrize("seed", SEEDS)
def test_rays_and_triangulation_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rays_t, rays_j = [], []
    for az in rng.uniform(-1.5, 1.5, 5):
        cam = OrbitCamera()
        cam.orbit(float(az), float(rng.uniform(-0.3, 0.3)), 0)
        m = cam.packed(16 / 9)
        x, y = rng.uniform(0.3, 0.7, 2)
        rays_t.append(tpl.LandmarkRay(m, x, y))
        rays_j.append(jpl.LandmarkRay(m, x, y))
        np.testing.assert_array_equal(rays_t[-1].origin, rays_j[-1].origin)
        np.testing.assert_array_equal(rays_t[-1].dir, rays_j[-1].dir)
    np.testing.assert_array_equal(rays_t[0].closest(rays_t[1]),
                                  rays_j[0].closest(rays_j[1]))
    np.testing.assert_array_equal(tpl.closest_point_between_rays(rays_t),
                                  jpl.closest_point_between_rays(rays_j))
    args = [rng.standard_normal(3) for _ in range(4)]
    np.testing.assert_array_equal(tpl.line_plane_intersection(*args),
                                  jpl.line_plane_intersection(*args))


@pytest.mark.parametrize("seed", SEEDS)
def test_compute_glasses_placement_equals_jax(seed):
    rng = np.random.default_rng(seed)
    nose = np.array([0.0, 0.1, 0.0])
    lms = [nose, nose + [0, -0.01, 0.01], nose + [0, -0.02, 0.02],
           np.array([-0.08, 0.12, -0.05]), np.array([0.08, 0.12, -0.05]),
           np.array([-0.085, 0.10, -0.05]), np.array([0.085, 0.10, -0.05]),
           np.array([-0.04, 0.11, 0.0]), np.array([0.04, 0.11, 0.0])]
    lms = [p + rng.normal(0, 0.004, 3) for p in lms]
    g_left = np.array([-0.732, -1.002, -0.057])
    g_right = np.array([0.732, -1.002, -0.057])
    t_t, s_t, r_t = tpl.compute_glasses_placement(lms, g_left, g_right)
    t_j, s_j, r_j = jpl.compute_glasses_placement(lms, g_left, g_right)
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(r_t, r_j)
    assert abs(np.linalg.norm(r_t) - 1.0) < 1e-9

"""Collide in the PyTorch port against the JAX package: alpha_at,
collide_distances / collide_march, and NerfMeshRenderer.collide with its
hull helpers.

Both packages load the same sphere snapshot (tests/helpers.py); the port's
renderer also takes the JAX Testbed's occupancy grid through
load_density_grid_array and the JAX node's transform, so both settle the
same mesh on the same scene. float32 MLPs, jitter off. Tolerances:
alpha_at 1e-5, distances 1e-4, node translation and rotation 1e-4, the
return value of collide equal on every call; the hull helpers exact.
"""

import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models import renderer as jrenderer
from nerf_glasses_tpu_torch.models import renderer as trenderer
from tests.helpers import write_quad_gltf, write_test_snapshot

torch.set_num_threads(1)

FAST = {"max_rounds": 96, "init_skip_iters": 24, "jitter": False,
        "compute_dtype": "float32"}
DOWN = np.array([0.0, -1.0, 0.0], np.float32)
OBLIQUE = np.array([0.3, -1.0, 0.2], np.float32)
# the quad rotated into the XZ plane, its normal pointing down
FLAT = [0.7071068, 0.7071068, 0.0, 0.0]


@pytest.fixture(scope="module")
def snapshot_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("snap") / "sphere.msgpack"
    write_test_snapshot(p)
    return str(p)


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    return str(write_quad_gltf(tmp_path_factory.mktemp("quad") / "q.gltf"))


def _pair(snapshot_path, cone_angle=None):
    """-> (JAX renderer, JAX Testbed), (port renderer, port Testbed), the
    port carrying the JAX occupancy grid."""
    jr = jrenderer.NerfMeshRenderer(8, 8)
    jn = jr.load_nerf(snapshot_path)
    tr = trenderer.NerfMeshRenderer(8, 8, device="cpu")
    tn = tr.load_nerf(snapshot_path)
    tr.load_density_grid_array(np.asarray(jn.occ))
    for n in (jn, tn):
        n.march_overrides = dict(FAST)
        if cone_angle is not None:
            n._cone_angle = cone_angle
    return (jr, jn), (tr, tn)


@pytest.fixture(scope="module")
def pair(snapshot_path):
    return _pair(snapshot_path)


def _points(seed, n=96):
    """Seeded NGP-space points: inside, around and above the sphere, and a
    few outside the unit cube."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.15, 0.85, (n, 3)).astype(np.float32)
    pts[: n // 2] = rng.uniform(0.35, 0.65, (n // 2, 3))   # mostly inside
    pts[n // 2: 3 * n // 4, 1] = rng.uniform(0.75, 0.95, n // 4)  # above it
    pts[-4:] = rng.uniform(1.02, 1.2, (4, 3))              # outside
    return pts


def test_alpha_at_matches_jax(pair):
    (_, jn), (_, tn) = pair
    pts = _points(0)
    a_j = np.asarray(jn.alpha_at(pts))
    a_t = tn.alpha_at(pts)
    assert a_t.shape == (len(pts),) and a_t.dtype == np.float32
    assert (a_j > 0).sum() > 5 and (a_j == 0).sum() > 5
    np.testing.assert_array_equal(a_t > 0, a_j > 0)
    np.testing.assert_allclose(a_t, a_j, atol=1e-5)


@pytest.mark.parametrize("direction, cone", [
    (DOWN, None), (OBLIQUE, None), (DOWN, 1.0 / 256.0)],
    ids=["down", "oblique", "down_cone_stepping"])
def test_collide_distances_match_jax(snapshot_path, pair, direction, cone):
    """Direction (0, -1, 0) has two zero components: 1/d is +inf there and
    the DDA must step on y alone in both packages."""
    (_, jn), (_, tn) = pair if cone is None else _pair(snapshot_path, cone)
    pts = _points(1)
    d_j = np.asarray(jn.collide_distances(pts, direction))
    d_t = tn.collide_distances(pts, direction)
    assert (d_j > 0).sum() > 5 and (d_j == 0).sum() > 5
    np.testing.assert_array_equal(d_t > 0, d_j > 0)
    np.testing.assert_allclose(d_t, d_j, atol=1e-4)
    assert 0 < tn.last_collide_turns < 1000


def test_collide_march_skips_the_network_without_candidates(pair):
    """Points over empty cells only: the loop ends when all have left the
    aabb, every distance is 0 and the density network never ran."""
    _, (_, tn) = pair
    calls = []
    real = tn.net.density_raw
    tn.net.density_raw = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        pts = np.array([[0.05, 0.9, 0.05], [0.95, 0.5, 0.95]], np.float32)
        dist = tn.collide_distances(pts, DOWN)
    finally:
        del tn.net.density_raw
    np.testing.assert_array_equal(dist, 0.0)
    assert not calls and tn.last_collide_turns > 10


def _settle(pair, quad, t, s, calls):
    """collide() `calls` times in both packages from the same start ->
    [(at_rest, translation, rotation)] per package."""
    out = []
    (jr, _), (tr, _) = pair
    jmesh = jr.load_mesh(quad, t=t, s=[s] * 3, r=FLAT)
    tmesh = tr.load_mesh(quad)
    jnode, tnode = jmesh.nodes[0], tmesh.nodes[0]
    tnode.translation = np.array(jnode.translation, np.float32)
    tnode.rotation = np.array(jnode.rotation, np.float32)
    tnode.scale = np.array(jnode.scale, np.float32)
    try:
        for r, node in ((jr, jnode), (tr, tnode)):
            steps = []
            for _ in range(calls):
                rest = r.collide(DOWN, node)
                steps.append((rest, node.translation.copy(),
                              node.rotation.copy()))
            out.append(steps)
    finally:
        jr.clear_meshes()
        tr.clear_meshes()
    return out


def _assert_same_steps(steps_j, steps_t):
    for (rest_j, t_j, r_j), (rest_t, t_t, r_t) in zip(steps_j, steps_t):
        assert rest_t == rest_j
        np.testing.assert_allclose(t_t, t_j, atol=1e-4)
        np.testing.assert_allclose(r_t, r_j, atol=1e-4)


def test_collide_free_fall_matches_jax(pair, quad):
    """The quad above the sphere (tests/test_hybrid.py:161-177): the first
    call translates it down onto the sphere, later calls find it in
    contact."""
    steps_j, steps_t = _settle(pair, quad, [0.0, 0.35, 0.0], 0.1, 4)
    _assert_same_steps(steps_j, steps_t)
    rest, t1, _ = steps_t[0]
    assert not rest and 0.0 < t1[1] < 0.30


@pytest.mark.parametrize("t, s, contacts", [
    ([0.12, 0.1, 0.0], 0.24, 2), ([0.14, 0.1, 0.14], 0.24, 1)],
    ids=["two_contacts", "one_contact"])
def test_collide_tips_off_centre_matches_jax(pair, quad, t, s, contacts):
    """A start that already intersects off-centre: with two corners in the
    sphere the quad tips around the line through them, with one corner
    around the axis centroid x direction; half a degree a call."""
    corners = (np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
               * (s / 2))
    ngp = np.stack([corners[:, 0] + t[0], np.full(4, t[1], np.float32),
                    corners[:, 1] + t[2]], 1) + 0.5
    assert (pair[1][1].alpha_at(ngp.astype(np.float32)) > 0).sum() == contacts
    steps_j, steps_t = _settle(pair, quad, t, s, 5)
    _assert_same_steps(steps_j, steps_t)
    rest, t1, r1 = steps_t[0]
    assert not rest
    assert not np.allclose(r1, FLAT, atol=1e-5)      # it rotated
    # half a degree: the rotation moved by sin(0.25 deg) at most
    assert np.abs(np.asarray(r1) - FLAT).max() < 0.01


def test_collide_without_facing_vertices(pair, quad):
    """The quad's normal points up: no vertex faces the fall, collide
    returns False and moves nothing (both packages)."""
    for r in (pair[0][0], pair[1][0]):
        mesh = r.load_mesh(quad, t=[0.0, 0.35, 0.0], s=[0.1] * 3,
                           r=[0.7071068, -0.7071068, 0.0, 0.0])
        node = mesh.nodes[0]
        assert r.collide(DOWN, node) is False
        np.testing.assert_array_equal(
            node.translation, np.array([0.0, 0.35, 0.0], np.float32))
        r.clear_meshes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hull_helpers_equal_jax(seed):
    """_graham_scan, _point_inside_hull and _normalize on seeded points
    (with duplicates and collinear runs): exactly the JAX package's."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((40, 2))
    pts[5] = pts[6]                                    # a duplicate
    pts[10:14] = np.linspace(pts[10], pts[13], 4)      # collinear
    h_j = jrenderer._graham_scan(pts)
    h_t = trenderer._graham_scan(pts)
    np.testing.assert_array_equal(h_t, h_j)
    assert len(h_t) >= 3
    for q in rng.standard_normal((30, 2)) * 1.5:
        assert (trenderer._point_inside_hull(h_t, q)
                == jrenderer._point_inside_hull(h_j, q))
    assert trenderer._point_inside_hull(h_t, h_t.mean(0))
    assert not trenderer._point_inside_hull(h_t, np.array([50.0, 50.0]))
    for k in (1, 2):    # degenerate hulls
        np.testing.assert_array_equal(trenderer._graham_scan(pts[:k]),
                                      jrenderer._graham_scan(pts[:k]))
        assert not trenderer._point_inside_hull(pts[:k], pts[0])
    v = rng.standard_normal(3)
    np.testing.assert_array_equal(trenderer._normalize(v),
                                  jrenderer._normalize(v))
    np.testing.assert_array_equal(trenderer._normalize(np.zeros(3)),
                                  jrenderer._normalize(np.zeros(3)))

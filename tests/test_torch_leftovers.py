"""The last public functions the port took over from the JAX package,
each against its JAX counterpart on the same seeded inputs.

- triangles.render_mesh_pass on tests/test_mesh.py's and
  tests/test_mesh_tiled.py's scenes: colour and depth atol 1e-5 (the same
  ray-cast and shading arithmetic; the rays are built in torch rather
  than numpy); the CPU's plain route against the tiled route the card
  takes (render_mesh_pass_tiled with the tiled kernel's plain version):
  atol 1e-5; ray tiles do not change the result. MeshArrays.n_tris and
  n_instances equal JAX's.
- bake.bake_density_grid: rtol 5e-3 (tests/test_torch_bake.py says why:
  the density MLP runs in bfloat16 in both packages).
- morton.morton3d_invert and morton_to_linear_lut: exact.
- hashgrid.level_corner_indices on a dense and a hashed level: indices
  exact, weights atol 1e-7.
- The BoundingBox methods contains, enlarge, inflate, intersects,
  ray_intersect and relative_pos, NerfDataset.n_extra_dims and
  Testbed.view_dir_prop: equal.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.config import grid_scale
from nerf_glasses_tpu.io import gltf as jgltf
from nerf_glasses_tpu.io.dataset import NerfDataset as JDataset
from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import bake as jbake
from nerf_glasses_tpu.ops import hashgrid as jhash
from nerf_glasses_tpu.ops import morton as jmorton
from nerf_glasses_tpu.ops import triangles as jtri
from nerf_glasses_tpu.utils.bbox import BoundingBox as JBox
from nerf_glasses_tpu_torch.io import gltf as tgltf
from nerf_glasses_tpu_torch.io.dataset import NerfDataset as TDataset
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import bake as tbake
from nerf_glasses_tpu_torch.ops import hashgrid as thash
from nerf_glasses_tpu_torch.ops import morton as tmorton
from nerf_glasses_tpu_torch.ops import triangles as ttri
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox as TBox
from tests.helpers import write_quad_gltf, write_test_snapshot

torch.set_num_threads(1)

MESH_ATOL = 1e-5


def _cam(x, y, z, eye):
    cam = np.zeros((3, 4), np.float32)
    cam[:, 0], cam[:, 1], cam[:, 2], cam[:, 3] = x, y, z, eye
    return cam


def _quads(tmp_path, loader, specs):
    scenes = []
    for i, (size, z, trans) in enumerate(specs):
        s = loader.load(str(write_quad_gltf(tmp_path / f"q{i}.gltf",
                                            size=size, z=z)))
        s.nodes[0].translation = np.array(trans, np.float32)
        scenes.append(s)
    return scenes


FRONT = _cam([0.5, 0, 0], [0, 0.5, 0], [0, 0, -1], [0, 0, 2])
# (quads (size, z, translation), camera, width, height): tests/test_mesh.py
# 's quad, back face, moved quad, and tests/test_mesh_tiled.py's two quads
MESH_CASES = {
    "quad": ([(1.0, 0.0, (0, 0, 0))], FRONT, 64, 64),
    "backface": ([(1.0, 0.0, (0, 0, 0))],
                 _cam([-0.5, 0, 0], [0, 0.5, 0], [0, 0, 1], [0, 0, -2]),
                 16, 16),
    "moved": ([(1.0, 0.0, (0, 0, 1.0))], FRONT, 8, 8),
    "two_quads": ([(0.8, 0.0, (0.3, 0.2, 0.0)), (0.5, 0.0, (-0.4, -0.3, 0.5))],
                  _cam([0.7, 0, 0], [0, 0.6, 0], [0, 0, -1],
                       [0.05, -0.02, 2.2]), 200, 150),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_render_mesh_pass_matches_jax(tmp_path, case):
    specs, cam, w, h = MESH_CASES[case]
    js = _quads(tmp_path, jgltf, specs)
    ts = _quads(tmp_path, tgltf, specs)
    jm, tm = jtri.build_mesh_arrays(js), ttri.build_mesh_arrays(ts)
    assert (tm.n_tris, tm.n_instances) == (jm.n_tris, jm.n_instances)
    xf, nm = ttri.instance_transforms(tm, ts)
    light = [1.0, 1.0, 1.0]
    jc, jd = jtri.render_mesh_pass(jm, xf, nm, cam, w, h, light)
    tc, td = ttri.render_mesh_pass(tm, xf, nm, cam, w, h, light)
    assert tc.shape == (h, w, 4) and td.shape == (h, w)
    np.testing.assert_allclose(tc, jc, atol=MESH_ATOL)
    np.testing.assert_allclose(td, jd, atol=MESH_ATOL)
    if case == "backface":
        assert tc[..., 3].max() == 0.0
    else:
        assert (td > 0).any()
    # the tiled route the card takes, and ray tiles of another size
    kc, kd = ttri.render_mesh_pass_tiled(tm, xf, nm, cam, w, h, light)
    np.testing.assert_allclose(kc.numpy(), tc, atol=MESH_ATOL)
    np.testing.assert_allclose(kd.numpy(), td, atol=MESH_ATOL)
    sc, sd = ttri.render_mesh_pass(tm, xf, nm, cam, w, h, light,
                                   tri_chunk=1, ray_tile=1000,
                                   device_out=True)
    assert torch.equal(sc, torch.as_tensor(tc))
    assert torch.equal(sd, torch.as_tensor(td))


def test_bake_density_grid_matches_jax(tmp_path):
    path = tmp_path / "sphere.msgpack"
    write_test_snapshot(path)
    j, t = JTestbed(), TTestbed(device="cpu")
    j.load_snapshot(str(path))
    t.load_snapshot(str(path))
    for occ in (None, "occ"):
        jg = jbake.bake_density_grid(j.params, j.config, 16, batch=1000,
                                     occ=None if occ is None else j.occ)
        tg = tbake.bake_density_grid(t.net, 16, batch=1000,
                                     occ=None if occ is None else t.occ)
        assert tg.shape == (16, 16, 16)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=5e-3,
                                   atol=1e-6)


def test_morton_invert_and_linear_lut_match_jax():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 128, size=(100, 3)).astype(np.uint32)
    m = tmorton.morton3d(xyz[:, 0], xyz[:, 1], xyz[:, 2])
    for shift in range(3):
        got = tmorton.morton3d_invert(m >> shift)
        np.testing.assert_array_equal(got, xyz[:, shift])
        np.testing.assert_array_equal(got, jmorton.morton3d_invert(m >> shift))
    for res in (8, 128):
        lut = tmorton.morton_to_linear_lut(res)
        np.testing.assert_array_equal(lut, jmorton.morton_to_linear_lut(res))
        np.testing.assert_array_equal(lut[tmorton.morton_order_lut(res)],
                                      np.arange(res ** 3))


@pytest.mark.parametrize("level", [0, 3], ids=["dense", "hashed"])
def test_level_corner_indices_matches_jax(level):
    cfg = JCfg(n_levels=4, log2_hashmap_size=7, base_resolution=4,
               per_level_scale=2.0)
    _, size, res = cfg.level_params()[level]
    scale = grid_scale(level, cfg.log2_per_level_scale, cfg.base_resolution)
    pos = np.random.default_rng(level).uniform(0, 1, (64, 3)).astype(
        np.float32)
    ji, jw = jhash.level_corner_indices(jnp.asarray(pos), res, scale, size)
    ti, tw = thash.level_corner_indices(torch.as_tensor(pos), res, scale,
                                        size)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)


def test_bounding_box_methods_match_jax():
    lo, hi = [0.0, -0.5, 0.2], [1.0, 0.5, 0.9]
    j, t = JBox(lo, hi), TBox(lo, hi)
    for p in ([0.5, 0.0, 0.5], [1.2, 0.0, 0.5], [1.0, 0.5, 0.9]):
        assert t.contains(p) == j.contains(p)
        np.testing.assert_array_equal(t.relative_pos(p), j.relative_pos(p))
    for o, d in (([0.5, 0.0, -1.0], [0, 0, 1]), ([2.0, 2.0, -1.0], [0, 0, 1]),
                 ([-1.0, 0.1, 0.5], [1.0, 0.2, 0.0])):
        np.testing.assert_array_equal(t.ray_intersect(o, d),
                                      j.ray_intersect(o, d))
    np.testing.assert_allclose(t.ray_intersect([0.5, 0.0, -1.0], [0, 0, 1]),
                               [1.2, 1.9], atol=1e-6)
    for other in ([[2, 2, 2], [3, 3, 3]], [[0.5, 0.4, 0.8], [3, 3, 3]]):
        assert t.intersects(TBox(*other)) == j.intersects(JBox(*other))
    t.enlarge(TBox([-1, 0, 0], [0, 2, 0]))
    j.enlarge(JBox([-1, 0, 0], [0, 2, 0]))
    t.enlarge([0.3, -3.0, 4.0])
    j.enlarge([0.3, -3.0, 4.0])
    t.inflate(0.25)
    j.inflate(0.25)
    np.testing.assert_array_equal(t.min, j.min)
    np.testing.assert_array_equal(t.max, j.max)
    assert t.min.dtype == j.min.dtype


@pytest.mark.parametrize("light,extra", [(False, 0), (True, 0), (True, 8),
                                         (False, 4)])
def test_dataset_n_extra_dims_matches_jax(light, extra):
    j, t = JDataset(), TDataset()
    for ds in (j, t):
        ds.has_light_dirs, ds.n_extra_learnable_dims = light, extra
    assert t.n_extra_dims == j.n_extra_dims == 3 * light + extra


def test_testbed_view_dir_prop_matches_jax():
    j, t = JTestbed(), TTestbed(device="cpu")
    np.testing.assert_array_equal(t.view_dir_prop, j.view_dir_prop)
    for tb in (j, t):
        tb.set_view_dir([0.3, -0.2, 0.9])
    np.testing.assert_allclose(t.view_dir_prop, j.view_dir_prop, atol=1e-7)
    np.testing.assert_array_equal(t.view_dir_prop, t.view_dir)

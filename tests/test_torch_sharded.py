"""The single-program hybrid frame and the untiled ray-cast: the PyTorch
port against the JAX package.

- raycast_reference (the plain version of the untiled CUDA kernel)
  against the TPU kernel raycast_pallas in interpret mode on identical
  inputs: triangle ids exactly equal; t, u, v to rtol 1e-4 / atol 1e-5
  (same f32 operations in the same order; XLA may contract products into
  FMAs, and a grazing ray (small det) amplifies that last-ulp difference).
- shade_hits_compacted against the JAX function: atol 1e-5 (the same
  shading arithmetic on the same hits).
- render_hybrid_sharded on tests/test_parallel.py's hybrid fixture (baked
  blob, quad mesh, flash options, jitter off, float32) at 64x32:
  n_shards=1 against the JAX package's make_mesh(1) and n_shards=8 against
  make_mesh(8), at atol 1e-4 on the linear frame and depth. The JAX side
  reads sigma from its brick table, the port from the dense grid (same
  trilinear maths, other summation order), and it shades the tails of its
  `chunk`-ray shade windows (rays with wn <= 1e-4, each adding at most
  1e-4 of colour) where the port shades none; 1e-4 covers both (measured:
  2.4e-7).
- Shard-count invariance of the port itself at atol 1e-6, and the
  occlusion asserts of tests/test_parallel.py:145-167.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_glasses_tpu.ops.mesh_pallas as mp
from nerf_glasses_tpu.io import gltf as jgltf
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops import triangles as jtri
from nerf_glasses_tpu.ops.bake import pack_sigma_bricks
from nerf_glasses_tpu.ops.network import init_params
from nerf_glasses_tpu.parallel import sharding as jsh
from nerf_glasses_tpu_torch.io import gltf as tgltf
from nerf_glasses_tpu_torch.ops import mesh_cuda
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops import triangles as ttri
from nerf_glasses_tpu_torch.ops.network import params_from_jax
from nerf_glasses_tpu_torch.parallel import sharding as tsh
from tests.helpers import write_quad_gltf
from tests.test_flash_failures import _cam
from tests.test_raymarch import CFG
from tests.test_torch_march import _np_params, _tcfg

torch.set_num_threads(1)

W, H = 64, 32
FRAME_ATOL = 1e-4


def _soup_rays(n_tris=300, n_rays=8192, seed=3):
    """Random triangles (both windings) in front of rays from z=2."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    v0[:, 2] = rng.uniform(-0.5, 0.5, n_tris)
    e = rng.uniform(-0.3, 0.3, (n_tris, 6)).astype(np.float32)
    tri = np.concatenate([v0, e], 1)
    o = np.tile(np.array([[0.05, -0.02, 2.0]], np.float32), (n_rays, 1))
    d = rng.normal(0, 0.3, (n_rays, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, o, d


def test_raycast_reference_matches_pallas_interpret():
    tri, o, d = _soup_rays()
    t, i, u, v = mesh_cuda.raycast(*(torch.as_tensor(a) for a in (tri, o, d)))
    jt, ji, ju, jv = mp.raycast_pallas(jnp.asarray(tri), jnp.asarray(o),
                                       jnp.asarray(d), tri.shape[0],
                                       interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    hit = i.numpy() >= 0
    assert 500 < hit.sum() < len(hit)
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t.numpy()[~hit], np.asarray(jt)[~hit])


def test_raycast_reference_blocks_do_not_matter():
    """Ray and triangle blocking does not change the answer: the first
    minimum in id order wins across blocks as within one."""
    tri, o, d = (torch.as_tensor(a) for a in _soup_rays(n_rays=3000))
    whole = mesh_cuda.raycast_reference(tri, o, d, ray_chunk=4096,
                                        tri_chunk=512)
    blocked = mesh_cuda.raycast_reference(tri, o, d, ray_chunk=700,
                                          tri_chunk=37)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def _quad_meshes(tmp_path):
    out = []
    for loader in (jgltf, tgltf):
        g = loader.load(str(write_quad_gltf(tmp_path / "q.gltf", size=0.2,
                                            z=0.0)))
        g.nodes[0].translation = np.array([0.0, 0.0, 0.35], np.float32)
        out.append(g)
    return out


def test_shade_hits_compacted_matches_jax(tmp_path):
    jg, tg = _quad_meshes(tmp_path)
    jm, tm = jtri.build_mesh_arrays([jg]), ttri.build_mesh_arrays([tg])
    xf, nm = ttri.instance_transforms(tm, [tg])
    cam = _cam()
    rng = np.random.default_rng(4)
    n = 2048
    d = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(cam[:, 3], (n, 1)).astype(np.float32)
    # hits from the port's plain ray-cast against the world-space quad
    v0 = (tm.v0.numpy() @ xf[0, :, :3].T) + xf[0, :, 3]
    e1 = tm.e1.numpy() @ xf[0, :, :3].T
    e2 = tm.e2.numpy() @ xf[0, :, :3].T
    tri_s = torch.as_tensor(np.concatenate([v0, e1, e2], 1).astype(np.float32))
    t, tri, u, v = mesh_cuda.raycast(tri_s, torch.as_tensor(o),
                                     torch.as_tensor(d))
    assert 100 < int((tri >= 0).sum()) < n
    uv = torch.stack([u, v], -1)
    light = np.array([1.0, 1.0, 1.0], np.float32)
    got = ttri.shade_hits_compacted(tm, torch.as_tensor(o), torch.as_tensor(d),
                                    t, tri, uv, torch.as_tensor(nm),
                                    torch.as_tensor(light),
                                    torch.as_tensor(cam[:, 3]))
    want = jtri.shade_hits_compacted(
        jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t.numpy()),
        jnp.asarray(tri.numpy()), jnp.asarray(uv.numpy()), jnp.asarray(nm),
        jnp.asarray(light), jnp.asarray(cam[:, 3]), chunk=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert (got.numpy()[tri.numpy() < 0] == 0).all()


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """tests/test_parallel.py::_hybrid_fixture for both packages: the
    spherical blob's occupancy and baked sigma, a quad in front of it,
    the flash options."""
    tmp = tmp_path_factory.mktemp("hybrid")
    params = init_params(jax.random.PRNGKey(2), CFG)
    g = (np.arange(128) + 0.5) / 128
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2)
    occ = np.zeros((8, 128, 128, 128), np.uint8)
    occ[0] = (r < 0.25).astype(np.uint8)
    occ[1:] = occ[0]
    R = 64
    gg = (np.arange(R) + 0.5) / R
    z2, y2, x2 = np.meshgrid(gg, gg, gg, indexing="ij")
    r2 = np.sqrt((x2 - 0.5) ** 2 + (y2 - 0.5) ** 2 + (z2 - 0.5) ** 2)
    sigma = np.where(r2 < 0.25, 25.0, 0.0).astype(np.float32)
    box = (np.zeros(3), np.ones(3), np.eye(3), np.zeros(3), np.ones(3))
    js = jrm.make_scene(occ, *box)
    js["sigma"] = pack_sigma_bricks(sigma)
    ts = trm.make_scene(occ, *box)
    ts["sigma"] = torch.as_tensor(sigma)
    jg, tg = _quad_meshes(tmp)
    jm, tm = jtri.build_mesh_arrays([jg]), ttri.build_mesh_arrays([tg])
    xf, nm = ttri.instance_transforms(tm, [tg])
    kw = dict(jitter=False, compute_dtype="float32", use_baked_sigma=True,
              deferred_color=True, lowres_factor=8, vector_rounds=True,
              steps_per_round=16, advance_iters=24, chunk=256, max_rounds=64)
    return {"jax": (params, js, jm, jrm.MarchOptions(config=CFG, **kw)),
            "port": (params_from_jax(_np_params(params), _tcfg(CFG)), ts, tm,
                     trm.MarchOptions(config=_tcfg(CFG), **kw)),
            "xf": xf, "nm": nm, "cam": _cam()}


def _port_frame(hybrid, n_shards):
    net, scene, tm, opts = hybrid["port"]
    return tsh.render_hybrid_sharded(net, scene, tm, hybrid["xf"],
                                     hybrid["nm"], hybrid["cam"], W, H, opts,
                                     n_shards=n_shards)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_hybrid_sharded_matches_jax(hybrid, n_shards):
    params, js, jm, jopts = hybrid["jax"]
    jf, jd = jsh.render_hybrid_sharded(params, js, jm, hybrid["xf"],
                                       hybrid["nm"], hybrid["cam"], W, H,
                                       jopts, jsh.make_mesh(n_shards))
    before = mesh_cuda.raycast_launches
    tf, td = _port_frame(hybrid, n_shards)
    assert mesh_cuda.raycast_launches == before   # CPU: the plain version
    assert tf.shape == (H, W, 4) and np.isfinite(tf).all()
    assert tf[..., 3].max() > 0.5
    np.testing.assert_allclose(tf, jf, atol=FRAME_ATOL)
    np.testing.assert_allclose(td, jd, atol=FRAME_ATOL)


def test_hybrid_shard_count_invariant(hybrid):
    f1, d1 = _port_frame(hybrid, 1)
    for n in (2, 4):
        fn, dn = _port_frame(hybrid, n)
        np.testing.assert_allclose(fn, f1, atol=1e-6)
        np.testing.assert_allclose(dn, d1, atol=1e-6)


def test_hybrid_sharded_mesh_occludes_nerf(hybrid):
    """tests/test_parallel.py::test_hybrid_sharded_mesh_occludes_nerf on
    the port: the quad (z=0.35, t_surface ~ 0.85) stops the center ray
    before the blob (front face t ~ 0.95); an off-axis ray that misses the
    quad records the blob's depth."""
    frame, depth = _port_frame(hybrid, 8)
    cy, cx = H // 2, W // 2
    assert frame[cy, cx, 3] > 0.9
    assert depth[cy, cx] == 0.0
    assert frame[cy, cx, 0] > frame[cy, cx, 1] + 0.05
    assert depth[cy, 40] > 0.5, depth[cy, 40]


def test_hybrid_sharded_rejects_uneven_bands(hybrid):
    net, scene, tm, opts = hybrid["port"]
    with pytest.raises(ValueError):
        tsh.make_hybrid_frame_sharded(3, tm, opts, W, H)

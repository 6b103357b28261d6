"""Mesh pass parity: the PyTorch port against the JAX package.

- The plain tiled ray-cast (raycast_tiled on CPU tensors) against the
  TPU kernel raycast_pallas_tiled run in interpret mode, on identical
  inputs: triangle ids exactly equal; t, u, v to rtol 1e-4 / atol 1e-5
  (same f32 operations in the same order, but XLA may contract products
  into FMAs, and a ray grazing a random triangle (small det) amplifies
  that last-ulp difference).
- Binning: counts and front-packed lists exactly equal.
- The factor-2 surface pass against the JAX render_mesh_pass_tiled
  (interpret mode) at atol 1e-4, as tests/test_mesh_tiled.py holds the
  JAX tiled pass against its brute-force path.
- The CUDA kernel against the plain version: tests/test_torch_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_glasses_tpu.ops.mesh_pallas as mp
from nerf_glasses_tpu.io import gltf as jgltf
from nerf_glasses_tpu.ops import triangles as jtri
from nerf_glasses_tpu_torch.io import gltf as tgltf
from nerf_glasses_tpu_torch.ops import mesh_cuda
from nerf_glasses_tpu_torch.ops import triangles as ttri
from tests.helpers import write_quad_gltf

torch.set_num_threads(1)

CAM = np.array([[0.7, 0.0, 0.0, 0.05],
                [0.0, 0.6, 0.0, -0.02],
                [0.0, 0.0, -1.0, 2.2]], np.float32)
LIGHT = [1.0, 1.0, 1.0]


def _quad_scenes(loader, tmp_path, textured):
    s1 = loader.load(str(write_quad_gltf(tmp_path / "q1.gltf", size=0.8)))
    s1.nodes[0].translation = np.array([0.3, 0.2, 0.0], np.float32)
    s1.nodes[0].rotation = np.array([0.98, 0.1, 0.17, 0.0], np.float32)
    s2 = loader.load(str(write_quad_gltf(tmp_path / "q2.gltf", size=0.5)))
    s2.nodes[0].translation = np.array([-0.4, -0.3, 0.5], np.float32)
    if textured:
        rng = np.random.default_rng(0)
        mat = s1.nodes[0].mesh.primitives[0].material
        mat.base_color_texture = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
        mat.metallic_roughness_texture = rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)
        mat.normal_texture = rng.uniform(0.3, 0.7, (4, 8, 4)).astype(np.float32)
        mat.metallic_factor = 0.7
        mat.roughness_factor = 0.4
    return [s1, s2]


def _soup(n=300, seed=0):
    """Random triangle soup in front of CAM, both windings."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    v0[:, 2] = rng.uniform(-0.5, 0.5, n)
    e1 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    return v0, e1, e2


def _soup_inputs(w=256, h=128):
    v0, e1, e2 = (torch.as_tensor(a) for a in _soup())
    cam = torch.as_tensor(CAM)
    wp, hp = -(-w // 128) * 128, -(-h // 64) * 64
    lists, counts = ttri._bin_triangles(v0, e1, e2, cam[:, 3],
                                        torch.linalg.inv(cam[:, :3]), w, h,
                                        wp, hp)
    ntx, nty = wp // 128, hp // 64
    px = (torch.arange(wp) + 0.5) / w * 2 - 1
    py = (torch.arange(hp) + 0.5) / h * 2 - 1
    ndc = torch.stack([px[None].expand(hp, wp), py[:, None].expand(hp, wp),
                       torch.ones(hp, wp)], -1)
    d = ndc @ cam[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d.reshape(nty, 64, ntx, 128, 3).permute(0, 2, 1, 3, 4).reshape(-1, 3)
    return (torch.cat([v0, e1, e2], 1).contiguous(),
            cam[:, 3].expand(d.shape).contiguous(), d.contiguous(), lists,
            counts)


def _quad_inputs(tmp_path, w=200, h=150):
    scenes = _quad_scenes(tgltf, tmp_path, textured=False)
    mesh = ttri.build_mesh_arrays(scenes)
    xf, _ = ttri.instance_transforms(mesh, scenes)
    inp = ttri.tiled_raycast_inputs(mesh, xf, CAM, w, h)
    return (inp["tri_scalars"], inp["o"], inp["d"], inp["tile_lists"],
            inp["tile_counts"])


@pytest.mark.parametrize("scene", ["quads", "soup"])
def test_plain_raycast_matches_pallas_interpret(scene, tmp_path):
    args = _quad_inputs(tmp_path) if scene == "quads" else _soup_inputs()
    t, i, u, v = mesh_cuda.raycast_tiled(*args)
    jt, ji, ju, jv = mp.raycast_pallas_tiled(
        *(jnp.asarray(a.numpy()) for a in args), interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    hit = i.numpy() >= 0
    assert hit.sum() > 100
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t.numpy()[~hit], np.asarray(jt)[~hit])


def test_plain_raycast_matches_bruteforce():
    """Tile culling loses no hit: the tiled plain version equals the
    brute-force ray-cast over all triangles."""
    tri, o, d, lists, counts = _soup_inputs()
    t, i, u, v = mesh_cuda.raycast_tiled(tri, o, d, lists, counts)
    bt, bi, buv = ttri._raycast_chunked(o, d, tri[:, :3], tri[:, 3:6],
                                        tri[:, 6:], chunk=64)
    np.testing.assert_array_equal(i.numpy(), bi.numpy())
    np.testing.assert_array_equal(t.numpy(), bt.numpy())


def test_raycast_chunked_matches_jax(tmp_path):
    tri, o, d, _, _ = _soup_inputs()
    sel = slice(0, 4096)
    bt, bi, buv = ttri._raycast_chunked(o[sel], d[sel], tri[:, :3],
                                        tri[:, 3:6], tri[:, 6:], chunk=64)
    jt, ji, juv = jtri._raycast_chunked(
        *(jnp.asarray(a.numpy()) for a in (o[sel], d[sel], tri[:, :3],
                                           tri[:, 3:6], tri[:, 6:])),
        64, cull_backfaces=True)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt), rtol=1e-5)


@pytest.mark.parametrize("size", [(256, 128), (200, 150), (300, 70)])
def test_binning_matches_jax(size):
    w, h = size
    v0, e1, e2 = _soup()
    cam = CAM.copy()
    inv = np.linalg.inv(cam[:, :3]).astype(np.float32)
    wp, hp = -(-w // 128) * 128, -(-h // 64) * 64
    lists, counts = ttri._bin_triangles(
        *(torch.as_tensor(a) for a in (v0, e1, e2, cam[:, 3], inv)),
        w, h, wp, hp)
    jl, jc = jtri._bin_triangles(*(jnp.asarray(a) for a in
                                   (v0, e1, e2, cam[:, 3], inv)),
                                 w, h, wp, hp)
    jl, jc = np.asarray(jl), np.asarray(jc)
    np.testing.assert_array_equal(counts.numpy(), jc)
    for k, c in enumerate(jc):
        np.testing.assert_array_equal(lists.numpy()[k, :c], jl[k, :c])
    assert 0 < counts.sum() < len(v0) * len(jc)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_surface_factor2_matches_jax_tiled(textured, tmp_path, monkeypatch):
    W, H = 200, 150
    js = _quad_scenes(jgltf, tmp_path, textured)
    jm = jtri.build_mesh_arrays(js)
    jxf, jnm = jtri.instance_transforms(jm, js)
    orig = mp.raycast_pallas_tiled

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(mp, "raycast_pallas_tiled", interp)
    c_j, d_j = jtri.render_mesh_pass_tiled(jm, jxf, jnm, CAM, W, H, LIGHT,
                                           factor=2)
    ts = _quad_scenes(tgltf, tmp_path, textured)
    tm = ttri.build_mesh_arrays(ts)
    txf, tnm = ttri.instance_transforms(tm, ts)
    c_t, d_t = ttri.render_mesh_surface(tm, txf, tnm, CAM, W // 2, H // 2, 2,
                                        LIGHT)
    assert c_t.shape == (H // 2, W // 2, 4) and d_t.shape == (H // 2, W // 2)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)
    assert (d_t.numpy() > 0).mean() > 0.1


def test_fused_reduce_equals_downsample(tmp_path):
    """factor-2 fused reduce == full-resolution pass + downsample_surface."""
    ts = _quad_scenes(tgltf, tmp_path, textured=True)
    tm = ttri.build_mesh_arrays(ts)
    xf, nm = ttri.instance_transforms(tm, ts)
    c2, d2 = ttri.render_mesh_surface(tm, xf, nm, CAM, 100, 60, 2, LIGHT)
    c1, d1 = ttri.render_mesh_pass_tiled(tm, xf, nm, CAM, 200, 120, LIGHT)
    cd, dd = ttri.downsample_surface(c1, d1, 2)
    np.testing.assert_allclose(c2.numpy(), cd.numpy(), atol=1e-6)
    np.testing.assert_array_equal(d2.numpy(), dd.numpy())


def test_downsample_surface_matches_jax():
    rng = np.random.default_rng(7)
    color = rng.uniform(0, 1, (12, 16, 4)).astype(np.float32)
    depth = rng.uniform(0, 3, (12, 16)).astype(np.float32)
    cj, dj = jtri.downsample_surface(jnp.asarray(color), jnp.asarray(depth), 2)
    ct, dt = ttri.downsample_surface(torch.as_tensor(color),
                                     torch.as_tensor(depth), 2)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))

"""The frame around the march (ops/frame_cuda.py): each kernel's plain
version against its JAX counterpart on the same seeded inputs, and the
hybrid frame end to end against the JAX renderer.

- Mesh plan: tile lists (the front-packed candidates) and counts exactly
  JAX's `_bin_triangles` on JAX's world triangles; the rays and world
  triangles within 1e-6 of `render_mesh_pass_tiled`'s set-up.
- Surface shade: the FxF surface from the same ray-cast hits as JAX's
  `shade_hits`, sRGB and `downsample_surface` make it: colour within
  1e-5, depth equal; plain and textured materials, F = 1 and 2.
- Ray init: the state of `_make_state` (JAX's init_rays, its walk where
  it has probes, the flash floor) within 1e-6, the alive flags equal, the
  first list the alive rays as a set; the rays within 1e-6 of JAX's
  frame function's.
- Finalize: `_finalize` then `_shade_frame` within 1e-6, depth equal.
- The hybrid frame (a trained head and a sphere, a mesh of two
  materials) against the JAX renderer at >= 50 dB, as
  tests/test_torch_slice.py holds it.
The wrappers' checks and the kernels against their plain versions on the
card (`cuda`) are in tests/test_torch_frame_card.py, which imports no
JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.io import gltf as jgltf
from nerf_glasses_tpu.models.renderer import NerfMeshRenderer as JRenderer
from nerf_glasses_tpu.ops import colors as jcolors
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops import triangles as jtri
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.io import gltf as tgltf
from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer as TRenderer
from nerf_glasses_tpu_torch.ops import frame_cuda, mesh_cuda
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops import triangles as ttri
from tests.helpers import write_test_snapshot
# the scenes and ray-init cases the card's tests take too
from tests.test_torch_frame_card import (  # noqa: F401
    CAM, CFG, LIGHT, RCAM, RH, RW, _scenes, grid_path, ray_case,
    sphere_occupancy)

torch.set_num_threads(1)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "trained", "trained_head_v6.msgpack")
PSNR_DB = 50.0


def _meshes(grid_path, textured):
    js = _scenes(jgltf, grid_path, textured)
    jm = jtri.build_mesh_arrays(js)
    jxf, jnm = jtri.instance_transforms(jm, js)
    ts = _scenes(tgltf, grid_path, textured)
    tm = ttri.build_mesh_arrays(ts)
    txf, tnm = ttri.instance_transforms(tm, ts)
    return (jm, jxf, jnm), (tm, txf, tnm)


# ---------------------------------------------------------------------------
# nmr_mesh_plan's plain version against JAX
# ---------------------------------------------------------------------------

def _jax_plan(jm, jxf, cam, width, height):
    """render_mesh_pass_tiled's set-up (nerf_glasses_tpu/ops/triangles.py
    :416-446): tile-major rays, world triangles, _bin_triangles."""
    tw, th = jtri.TILE_W, jtri.TILE_H
    wp, hp = -(-width // tw) * tw, -(-height // th) * th
    ntx, nty = wp // tw, hp // th
    cam = jnp.asarray(cam)
    cam3 = cam[:, :3]
    px = jnp.broadcast_to(jnp.arange(wp, dtype=jnp.float32)[None] + 0.5, (hp, wp))
    py = jnp.broadcast_to(jnp.arange(hp, dtype=jnp.float32)[:, None] + 0.5, (hp, wp))
    ndc = jnp.stack([px / width * 2.0 - 1.0, py / height * 2.0 - 1.0,
                     jnp.ones((hp, wp))], axis=-1)
    d = ndc @ cam3.T
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    d_t = d.reshape(nty, th, ntx, tw, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)
    xf = jnp.asarray(jxf)
    rot = xf[jm.inst_id, :, :3]
    v0 = jnp.einsum("tij,tj->ti", rot, jm.v0) + xf[jm.inst_id, :, 3]
    e1 = jnp.einsum("tij,tj->ti", rot, jm.e1)
    e2 = jnp.einsum("tij,tj->ti", rot, jm.e2)
    lists, counts = jtri._bin_triangles(v0, e1, e2, cam[:, 3],
                                        jnp.linalg.inv(cam3), width, height,
                                        wp, hp)
    return (np.asarray(lists), np.asarray(counts), np.asarray(d_t),
            np.asarray(jnp.concatenate([v0, e1, e2], axis=1)))


@pytest.mark.parametrize("size", [(256, 128), (200, 150), (300, 70)])
def test_mesh_plan_matches_jax(grid_path, size):
    w, h = size
    (jm, jxf, _), (tm, txf, _) = _meshes(grid_path, False)
    plan = frame_cuda.mesh_plan(tm, txf, CAM, w, h)
    jl, jc, jd, jtris = _jax_plan(jm, jxf, CAM, w, h)
    counts = plan["tile_counts"].numpy()
    np.testing.assert_array_equal(counts, jc)
    for k, c in enumerate(jc):
        np.testing.assert_array_equal(plan["tile_lists"].numpy()[k, :c],
                                      jl[k, :c])
    assert 0 < counts.sum() < tm.n_tris * len(jc)
    assert plan["tile_lists"].shape == (len(jc), tm.n_tris)
    # each row holds every id once: the candidates, then the others ascending
    lists = plan["tile_lists"].numpy()
    for k, c in enumerate(counts):
        assert sorted(lists[k]) == list(range(tm.n_tris))
        assert (np.diff(lists[k, c:]) > 0).all()
    np.testing.assert_allclose(plan["d"].numpy(), jd, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(plan["tri_scalars"].numpy(), jtris, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(plan["o"].numpy(),
                                  np.broadcast_to(CAM[:, 3], jd.shape))


# ---------------------------------------------------------------------------
# nmr_surface_shade's plain version against JAX
# ---------------------------------------------------------------------------

def _jax_surface(jm, jnm, plan, hits, width, height, factor):
    """The JAX package's shading and reduce on the same hits: shade_hits,
    sRGB + coverage per ray, then downsample_surface."""
    ntx, nty = plan["ntx"], plan["nty"]
    tw, th = jtri.TILE_W, jtri.TILE_H

    def rows(x):       # tile-major (n, ...) -> row-major (hp, wp, ...)
        x = x.numpy()
        x = x.reshape((nty, ntx, th, tw) + x.shape[1:])
        x = np.swapaxes(x, 1, 2)
        return x.reshape((nty * th * ntx * tw,) + x.shape[4:])

    t, tri, u, v = (rows(x) for x in hits)
    d = rows(plan["d"])
    eye = jnp.asarray(CAM[:, 3])
    rgb = jtri.shade_hits(jm, jnp.broadcast_to(eye, d.shape), jnp.asarray(d),
                          jnp.asarray(t), jnp.asarray(tri),
                          jnp.stack([jnp.asarray(u), jnp.asarray(v)], -1),
                          jnp.asarray(jnm), jnp.asarray(LIGHT, jnp.float32),
                          eye)
    hit = tri >= 0
    color = jnp.concatenate([jcolors.linear_to_srgb(jnp.clip(rgb, 0.0, 1.0)),
                             jnp.asarray(hit, jnp.float32)[:, None]], -1)
    color = jnp.where(jnp.asarray(hit)[:, None], color, 0.0)
    depth = jnp.where(jnp.asarray(hit), jnp.asarray(t), 0.0)
    hp, wp = nty * th, ntx * tw
    c, dd = jtri.downsample_surface(color.reshape(hp, wp, 4),
                                    depth.reshape(hp, wp), factor)
    return (np.asarray(c)[:height // factor, :width // factor],
            np.asarray(dd)[:height // factor, :width // factor])


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_surface_shade_matches_jax(grid_path, textured, factor):
    w, h = 200, 150
    (jm, _, jnm), (tm, txf, tnm) = _meshes(grid_path, textured)
    plan = frame_cuda.mesh_plan(tm, txf, CAM, w, h)
    hits = mesh_cuda.raycast_tiled(plan["tri_scalars"], plan["o"], plan["d"],
                                   plan["tile_lists"], plan["tile_counts"])
    c_t, d_t = frame_cuda.surface_shade(tm, plan, hits, tnm, LIGHT, CAM, w, h,
                                        factor)
    assert c_t.shape == (h // factor, w // factor, 4)
    c_j, d_j = _jax_surface(jm, jnm, plan, hits, w, h, factor)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=1e-5)
    assert (d_t.numpy() > 0).mean() > 0.1
    # the frame's mesh pass is these two and the ray-cast
    c_r, d_r = ttri.render_mesh_pass_tiled(tm, txf, tnm, CAM, w, h, LIGHT,
                                           factor=factor)
    assert torch.equal(c_r, c_t) and torch.equal(d_r, d_t)


# ---------------------------------------------------------------------------
# nmr_ray_init's plain version against JAX
# ---------------------------------------------------------------------------

def _cfgs(aabb_scale):
    return (JCfg(**CFG, aabb_scale=aabb_scale),
            TCfg(**CFG, aabb_scale=aabb_scale))


def _jax_rays(cam, width, height, ox, oy):
    """_get_frame_fn's rays of a plain camera (nerf_glasses_tpu/ops/
    raymarch.py:1357-1405)."""
    cam = jnp.asarray(cam)
    px = jnp.broadcast_to(jnp.arange(width, dtype=jnp.float32)[None], (height, width))
    py = jnp.broadcast_to(jnp.arange(height, dtype=jnp.float32)[:, None], (height, width))
    u = (px + jnp.float32(ox)) / width
    v = (py + jnp.float32(oy)) / height
    dir_cam = jnp.stack([u * 2.0 - 1.0, v * 2.0 - 1.0,
                         jnp.ones((height, width))], -1).reshape(-1, 3)
    d = dir_cam @ cam[:, :3].T
    o = jnp.broadcast_to(cam[:, 3] + 0.5, d.shape)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", ["no_surface", "surface", "walk", "flash"])
@pytest.mark.parametrize("jitter", [False, True], ids=["still", "jitter"])
def test_ray_init_matches_jax(case, jitter):
    scale, kw, surf, tsurf, coarse = ray_case(case)
    jc, tc = _cfgs(scale)
    occ = sphere_occupancy(jc.max_cascade)
    box = (np.full(3, 0.1), np.full(3, 0.9), np.eye(3), np.zeros(3), np.ones(3))
    topts = trm.frame_options(trm.MarchOptions(config=tc, jitter=jitter,
                                               **kw))
    jopts = jrm.MarchOptions(config=jc, jitter=jitter, **{
        **kw, "init_skip_iters": topts.init_skip_iters})
    assert (topts.init_skip_iters > 0) == (case == "walk")
    offsets = (trm._radical_inverse(2, 4), trm._radical_inverse(3, 4))
    tscene = trm.make_scene(occ, *box)
    st, first = frame_cuda.ray_init(
        tscene, topts, RCAM, RW, RH, offsets, 3,
        None if surf is None else torch.as_tensor(surf).view(RH, RW, 4),
        None if tsurf is None else torch.as_tensor(tsurf).view(RH, RW),
        None if coarse is None else tuple(torch.as_tensor(x) for x in coarse),
        make_list=True)
    jo, jd = _jax_rays(RCAM, RW, RH, *offsets)
    np.testing.assert_allclose(st["o"].numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st["d"].numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    n = RW * RH
    jsurf = jnp.zeros((n, 4)) if surf is None else jnp.asarray(surf)
    jts = jnp.zeros((n,)) if tsurf is None else jnp.asarray(tsurf)
    t_floor = alive_mask = None
    if coarse is not None:
        t_floor, alive_mask = jrm.upsample_flash_init(
            jnp.asarray(coarse[0]), jnp.asarray(coarse[1]), RW, RH, 8)
    js = jrm._make_state(jrm.make_scene(occ, *box), jo, jd, jsurf, jts, jopts,
                         3, t_floor, alive_mask)
    np.testing.assert_array_equal(st["alive"].numpy(), np.asarray(js["alive"]))
    for k in ("t", "t_start", "surf_a", "rgba", "depth", "max_weight", "wn",
              "surf", "t_surf"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    ids, count = first
    assert int(count) == int(st["alive"].sum()) > 0
    assert set(ids[:int(count)].tolist()) == set(
        np.flatnonzero(np.asarray(js["alive"])).tolist())
    if case == "flash":
        assert not st["alive"].all()


# ---------------------------------------------------------------------------
# nmr_frame_finalize's plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("linear", [False, True], ids=["srgb", "linear"])
def test_finalize_matches_jax(linear):
    rng = np.random.default_rng(4)
    h, w = 24, 32
    n = h * w
    rgba = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    rgba[:, 3] = rng.choice([0.0, 0.0005, 0.001, 0.0011, 0.2, 0.2001, 0.7,
                             1.0], n).astype(np.float32)
    rgba[:40, :3] = rng.uniform(0, 0.05, (40, 3))      # the linear segment
    depth = rng.uniform(0.5, 3.0, n).astype(np.float32)
    frame, dep = frame_cuda.finalize(torch.as_tensor(rgba),
                                     torch.as_tensor(depth), w, h, linear)
    jst = jrm._finalize({"rgba": jnp.asarray(rgba), "depth": jnp.asarray(depth)})
    jframe = jrm._shade_frame(jst["rgba"].reshape(h, w, 4), linear)
    assert frame.shape == (h, w, 4) and dep.shape == (h, w)
    np.testing.assert_allclose(frame.numpy(), np.asarray(jframe), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(dep.numpy(),
                                  np.asarray(jst["depth"]).reshape(h, w))
    assert (dep.numpy() == 0).any() and (dep.numpy() > 0).any()


# ---------------------------------------------------------------------------
# The hybrid frame end to end
# ---------------------------------------------------------------------------

def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


@pytest.mark.parametrize("scene", ["trained_head", "sphere"])
def test_hybrid_frame_matches_jax(scene, grid_path, tmp_path):
    """load_nerf + load_mesh (the grid mesh, two materials) + two frames at 64x48 with the mesh pass at 2x: JAX renderer against
    the port's, whose every stage around the march is a frame_cuda plain
    version here."""
    if scene == "sphere":
        snap = str(tmp_path / "sphere.msgpack")
        write_test_snapshot(snap)
    else:
        snap = TRAINED
    imgs = []
    for make in (lambda: JRenderer(64, 48),
                 lambda: TRenderer(64, 48, device="cpu")):
        r = make()
        nerf = r.load_nerf(snap)
        nerf.march_overrides = {"jitter": False, "compute_dtype": "float32",
                                "max_rounds": 96}
        assert r.load_mesh(str(grid_path), t=[0.0, 0.05, 0.25],
                           s=[0.3, 0.3, 0.3]) is not None
        if scene == "trained_head":
            nerf.render_aabb.min = np.array([0.1, 0.1, 0.1], np.float32)
            nerf.render_aabb.max = np.array([0.9, 0.9, 0.9], np.float32)
            r.orbit(0.4, -0.1, 0)
            r.orbit(0, 0, 3.5)
        for _ in range(2):
            assert r.frame()
        imgs.append((r.display_image(), np.asarray(r._frame_buffer),
                     np.asarray(nerf._surface_t)))
    (ji, _, _), (ti, tfb, tsurf) = imgs
    assert (tsurf > 0).mean() > 0.02              # the mesh is in the frame
    assert (tfb[..., 3] > 0.5).mean() > 0.01
    assert psnr(ti[..., :3], ji[..., :3]) >= PSNR_DB

"""The frame kernels (ops/frame_cuda.py) without JAX: the wrappers'
checks on every device, the packed materials, the surface shade's and
the ray init's contracts, the ray init of given rays, and on the card
(`cuda` marker, skipped elsewhere) each kernel against its plain version
under `frame_cuda.compare_with_plain`'s contract. The plain versions
against the JAX package: tests/test_torch_frame_kernels.py, which takes
its scenes from here. On the card, from the repository root:
`python -m pytest tests/test_torch_frame_card.py -m cuda -q` (where
another `tests` package shadows tests/, bind it first, as README says).
"""

import base64
import json
import types

import numpy as np
import pytest
import torch

from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io import gltf as tgltf
from nerf_glasses_tpu_torch.ops import frame_cuda, mesh_cuda
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops import triangles as ttri
from nerf_glasses_tpu_torch.ops.network import init_params

torch.set_num_threads(1)

CAM = np.array([[0.7, 0.0, 0.0, 0.05],
                [0.0, 0.6, 0.0, -0.02],
                [0.0, 0.0, -1.0, 2.2]], np.float32)
LIGHT = [1.0, 1.0, 1.0]
RCAM = np.array([[0.55, 0.0, 0.1, 0.0],
                 [0.0, 0.5, 0.0, 0.0],
                 [-0.1, 0.0, 1.0, -1.6]], np.float32)   # eye (.5, .5, -1.1)
RW, RH = 64, 48
CFG = dict(n_levels=4, log2_hashmap_size=7, base_resolution=4,
           per_level_scale=2.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def _grid(n, seed, z0):
    """A wavy n x n grid of quads facing +z: positions, normals, uvs
    (spanning [-0.5, 1.5], so textures wrap), triangle indices."""
    rng = np.random.default_rng(seed)
    s = np.linspace(-0.5, 0.5, n + 1, dtype=np.float32)
    x, y = np.meshgrid(s, s)
    z = z0 + 0.05 * np.sin(6.0 * x) * np.cos(5.0 * y) \
        + rng.uniform(-0.01, 0.01, x.shape)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([-0.3 * np.cos(6.0 * x) * np.cos(5.0 * y),
                    0.25 * np.sin(6.0 * x) * np.sin(5.0 * y),
                    np.ones_like(x)], -1).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    uv = (np.stack([x, y], -1).reshape(-1, 2) * 2.0 + 0.5).astype(np.float32)
    k = np.arange(n * n)
    r, c = k // n, k % n
    a, b = r * (n + 1) + c, r * (n + 1) + c + 1
    cc, d = a + n + 1, b + n + 1
    idx = np.stack([a, b, d, a, d, cc], -1).reshape(-1).astype(np.uint16)
    return pos, nrm, uv, idx


def write_grid_gltf(path, n=8):
    """A glTF mesh of two primitives (2 n^2 triangles each), two
    materials: a wavy grid and a smaller one in front of it."""
    buf, views, accessors, prims = b"", [], [], []
    for p, (seed, z0, scale) in enumerate(((0, 0.0, 1.0), (1, 0.15, 0.5))):
        pos, nrm, uv, idx = _grid(n, seed, z0)
        pos = pos * np.array([scale, scale, 1.0], np.float32)
        attrs = {}
        for name, arr, kind in (("POSITION", pos, "VEC3"),
                                ("NORMAL", nrm, "VEC3"),
                                ("TEXCOORD_0", uv, "VEC2"),
                                (None, idx, "SCALAR")):
            raw = arr.tobytes()
            views.append({"buffer": 0, "byteOffset": len(buf),
                          "byteLength": len(raw)})
            acc = {"bufferView": len(views) - 1,
                   "componentType": 5123 if name is None else 5126,
                   "count": len(arr), "type": kind}
            if name == "POSITION":
                acc.update(min=pos.min(0).tolist(), max=pos.max(0).tolist())
            accessors.append(acc)
            buf += raw + b"\0" * (-len(raw) % 4)
            if name is not None:
                attrs[name] = len(accessors) - 1
        prims.append({"attributes": attrs, "indices": len(accessors) - 1,
                      "material": p})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0, "name": "grid"}],
        "meshes": [{"primitives": prims}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.3, 0.2, 1.0],
                                      "metallicFactor": 0.2,
                                      "roughnessFactor": 0.6}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.5, 0.9, 1.0],
                                      "metallicFactor": 0.8,
                                      "roughnessFactor": 0.3},
             "emissiveFactor": [0.05, 0.02, 0.0]}],
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}]}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _scenes(loader, path, textured):
    """Two instances of the grid mesh; with `textured`, every texture
    slot of the first material and the normal map of the second."""
    s1 = loader.load(str(path))
    s1.nodes[0].translation = np.array([0.2, 0.1, 0.0], np.float32)
    s1.nodes[0].rotation = np.array([0.98, 0.1, 0.17, 0.0], np.float32)
    s2 = loader.load(str(path))
    s2.nodes[0].translation = np.array([-0.35, -0.25, 0.4], np.float32)
    s2.nodes[0].scale = np.array([0.6, 0.6, 0.6], np.float32)
    if textured:
        rng = np.random.default_rng(5)
        for s in (s1, s2):
            m0 = s.nodes[0].mesh.primitives[0].material
            m1 = s.nodes[0].mesh.primitives[1].material
            m0.base_color_texture = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
            m0.metallic_roughness_texture = rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)
            m0.emissive_texture = rng.uniform(0, 0.2, (4, 8, 4)).astype(np.float32)
            m0.normal_texture = rng.uniform(0.3, 0.7, (4, 8, 4)).astype(np.float32)
            m0.occlusion_texture = rng.uniform(0.5, 1, (8, 4, 4)).astype(np.float32)
            m0.occlusion_strength = 0.7
            m0.normal_scale = 0.8
            m1.normal_texture = rng.uniform(0.3, 0.7, (8, 8, 4)).astype(np.float32)
    return [s1, s2]


@pytest.fixture(scope="module")
def grid_path(tmp_path_factory):
    return write_grid_gltf(tmp_path_factory.mktemp("grid") / "grid.gltf")


def _mesh(grid_path, textured, device="cpu"):
    ts = _scenes(tgltf, grid_path, textured)
    tm = ttri.build_mesh_arrays(ts, device=device)
    xf, nm = ttri.instance_transforms(tm, ts)
    return tm, xf, nm


def sphere_occupancy(max_cascade, radius=0.25):
    """The occupancy grid (8, 128^3) uint8 of a solid sphere in every
    cascade (the port's build_occupancy)."""
    g = np.linspace(0, 1, 128, endpoint=False) + 0.5 / 128
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    grid = np.tile((r < radius).astype(np.float32)[None],
                   (max_cascade + 1, 1, 1, 1))
    return tocc.build_occupancy(torch.as_tensor(grid), max_cascade).numpy()


def ray_case(case):
    """-> (aabb_scale, options kwargs, surface (N, 4) or None, t_surface,
    coarse grids or None) of a 64x48 frame."""
    rng = np.random.default_rng(11)
    n = RW * RH
    surf = tsurf = coarse = None
    if case != "no_surface":
        has = rng.uniform(size=n) < 0.3
        tsurf = np.where(has, rng.uniform(1.2, 2.4, n), 0.0).astype(np.float32)
        surf = np.where(has[:, None], rng.uniform(0, 1, (n, 4)), 0.0).astype(
            np.float32)
        surf[has & (rng.uniform(size=n) < 0.5), 3] = 1.0
    if case == "walk":
        return 2, {"cone_angle": 1.0 / 256}, surf, tsurf, None
    opts = {}
    if case == "flash":
        f = 8
        hl, wl = -(-RH // f), -(-RW // f)
        alive = rng.uniform(size=(hl, wl)) < 0.6
        tmin = np.where(alive, rng.uniform(1.0, 2.0, (hl, wl)), 0.0).astype(
            np.float32)
        coarse = (tmin, alive)
        opts = {"lowres_factor": f}
    return 1, opts, surf, tsurf, coarse


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_mesh_plan_is_tiled_raycast_inputs(grid_path):
    tm, txf, _ = _mesh(grid_path, True)
    a = frame_cuda.mesh_plan(tm, txf, CAM, 200, 150)
    b = ttri.tiled_raycast_inputs(tm, txf, CAM, 200, 150)
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k


def test_tiled_raycast_reads_each_list_to_its_count(grid_path):
    """The tiled ray-cast's plain version reads no list entry past its
    tile's count, where the mesh plan kernel writes nothing: any ids
    there leave its hits as they were."""
    tm, txf, _ = _mesh(grid_path, False)
    plan = frame_cuda.mesh_plan(tm, txf, CAM, 256, 192)
    args = (plan["tri_scalars"], plan["o"], plan["d"])
    want = mesh_cuda.raycast_tiled(*args, plan["tile_lists"],
                                   plan["tile_counts"])
    lists = plan["tile_lists"].clone()
    past = (torch.arange(lists.shape[1])[None]
            >= plan["tile_counts"][:, None])
    lists[past] = tm.n_tris + 1000
    got = mesh_cuda.raycast_tiled(*args, lists, plan["tile_counts"])
    assert int((want[1] >= 0).sum()) > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _idle_tiles(plan):
    """(busy, idle) tile masks of a plan: count above 0, or 0."""
    busy = plan["tile_counts"] > 0
    return busy, ~busy


def _with_idle_rays(plan, fill):
    """The plan with the rays of its tiles of count 0 replaced: fill(the
    (idle tiles, 8192, 3) block) gives the new rays."""
    _, idle = _idle_tiles(plan)
    out = dict(plan)
    for k in ("o", "d"):
        x = plan[k].clone().view(idle.shape[0], -1, 3)
        x[idle] = fill(k, x[idle])
        out[k] = x.view(-1, 3)
    return out


def test_idle_tiles_rays_are_read_by_nothing(grid_path):
    """The mesh plan kernel leaves the rays of a tile with no candidate
    unwritten: the tiled ray-cast's and the surface shade's plain versions
    give the same outputs, bit for bit, when every such ray is NaN."""
    tm, txf, tnm = _mesh(grid_path, True)
    w, h = 768, 576
    plan = frame_cuda.mesh_plan(tm, txf, CAM, w, h)
    busy, idle = _idle_tiles(plan)
    assert int(busy.sum()) > 0 and int(idle.sum()) > 0
    poisoned = _with_idle_rays(plan, lambda k, x: torch.full_like(x, np.nan))
    assert bool(torch.isnan(poisoned["d"]).any())
    hits = [mesh_cuda.raycast_tiled_reference(
        p["tri_scalars"], p["o"], p["d"], p["tile_lists"], p["tile_counts"])
        for p in (plan, poisoned)]
    assert int((hits[0][1] >= 0).sum()) > 100
    for a, b in zip(*hits):
        assert torch.equal(a, b)
    for factor in (1, 2):
        got = [frame_cuda.surface_shade_reference(tm, p, hits[0], tnm, LIGHT,
                                                  CAM, w, h, factor)
               for p in (plan, poisoned)]
        for a, b in zip(*got):
            assert torch.equal(a, b)
    # the contract holds the kernel to the busy tiles' rays only
    r = frame_cuda.compare_with_plain("mesh_plan", poisoned, plan)
    assert r["ok"] and r["busy_tiles"] == int(busy.sum()), r


def test_pack_materials_views(grid_path):
    tm, _, _ = _mesh(grid_path, True)
    assert tm.mat_table.shape == (len(tm.materials), frame_cuda.MAT_STRIDE)
    for k, mat in enumerate(tm.materials):
        np.testing.assert_array_equal(tm.mat_table[k, :4].numpy(),
                                      mat.base_color_factor)
        assert float(tm.mat_table[k, 5]) == np.float32(mat.roughness_factor)
        for s, name in enumerate(frame_cuda.TEX_SLOTS):
            tex = getattr(mat, name)
            if tex is None:
                assert name not in tm.textures[k]
                assert int(tm.tex_table[k, s, 1]) == 0
                continue
            view = tm.textures[k][name]
            assert view.data_ptr() == (tm.texels.data_ptr()
                                       + 4 * int(tm.tex_table[k, s, 0]))
            np.testing.assert_array_equal(view.numpy(), tex)
            assert tm.tex_table[k, s, 1:].tolist() == [tex.shape[0],
                                                       tex.shape[1], 4]


def test_ray_init_other_cameras_take_the_plain_version():
    """rays=(o, d) (a lens, a shutter, DoF) on the CPU: the plain version
    on those rays, the state of make_state."""
    scale, kw, surf, tsurf, _ = ray_case("surface")
    occ = np.ones((1, 128, 128, 128), np.uint8)
    tscene = trm.make_scene(occ, np.zeros(3), np.ones(3), np.eye(3),
                            np.zeros(3), np.ones(3))
    opts = trm.frame_options(trm.MarchOptions(
        config=NGPConfig(**CFG, aabb_scale=scale)))
    rng = np.random.default_rng(3)
    n = RW * RH
    o = torch.as_tensor(np.tile([[0.5, 0.5, -1.0]], (n, 1)).astype(np.float32))
    d = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32) * 0.2)
    d[:, 2] = 1.0
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    st, first = frame_cuda.ray_init(tscene, opts, None, RW, RH, (0.5, 0.5), 2,
                                    torch.as_tensor(surf),
                                    torch.as_tensor(tsurf), rays=(o, d))
    want = trm._make_state(tscene, o, d, torch.as_tensor(surf),
                           torch.as_tensor(tsurf), opts, 2)
    assert first is None
    for k in want:
        assert torch.equal(st[k], want[k]), k


def test_ray_init_takes_a_floor_per_ray():
    """A batch of given rays as a row of N with a per-ray flash floor
    (coarse_factor 1), as march_frame_impl hands it over: make_state's
    state with t_floor and alive_mask, and the alive rays as the list."""
    scale, kw, surf, tsurf, coarse = ray_case("flash")
    scene = trm.make_scene(sphere_occupancy(0), np.full(3, 0.1),
                           np.full(3, 0.9), np.eye(3), np.zeros(3),
                           np.ones(3))
    opts = trm.frame_options(trm.MarchOptions(
        config=NGPConfig(**CFG, aabb_scale=scale), **kw))
    o, d = (torch.as_tensor(x) for x in trm.camera_rays(RCAM, RW, RH))
    s, ts = torch.as_tensor(surf), torch.as_tensor(tsurf)
    t_floor, alive = trm.upsample_flash_init(
        *(torch.as_tensor(x) for x in coarse), RW, RH, kw["lowres_factor"])
    n = RW * RH
    st, first = frame_cuda.ray_init(
        scene, opts, None, n, 1, (0.5, 0.5), 0, s, ts,
        (t_floor.reshape(1, n), alive.reshape(1, n)), make_list=True,
        rays=(o, d), coarse_factor=1)
    want = trm._make_state(scene, o, d, s, ts, opts, 0, t_floor, alive)
    for k in want:
        assert torch.equal(st[k], want[k]), k
    assert 0 < int(first[1]) < n
    assert torch.equal(first[0][:int(first[1])].long(),
                       torch.nonzero(want["alive"]).squeeze(1))
    assert not any(frame_cuda.plain_on_card.values())


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_shade_contract_takes_an_ulp_of_the_normals(grid_path, textured,
                                                    factor):
    """The surface shade's contract against the plain version with every
    vertex normal and tangent one float32 step off (a rounding the kernel
    may take): it holds, flat at 1e-5 on the untextured materials, and
    through the pixels' rounding sensitivity on the textured ones, whose
    near-zero roughness and normal maps move some pixels by more."""
    tm, txf, tnm = _mesh(grid_path, textured)
    w, h = 256, 192
    plan = frame_cuda.mesh_plan(tm, txf, CAM, w, h)
    hits = mesh_cuda.raycast_tiled(plan["tri_scalars"], plan["o"], plan["d"],
                                   plan["tile_lists"], plan["tile_counts"])
    want = frame_cuda.surface_shade_reference(tm, plan, hits, tnm, LIGHT, CAM,
                                              w, h, factor)
    off = types.SimpleNamespace(**vars(tm))
    off.n = torch.nextafter(tm.n, torch.full_like(tm.n, 2.0))
    off.tan = torch.nextafter(tm.tan, torch.full_like(tm.tan, -2.0))
    got = frame_cuda.surface_shade_reference(off, plan, hits, tnm, LIGHT, CAM,
                                             w, h, factor)
    scale = frame_cuda.shade_error_scale(tm, plan, hits, tnm, LIGHT, CAM, w, h,
                                         factor)
    r = frame_cuda.compare_with_plain("surface_shade", got, want, scale)
    assert r["ok"], r
    flat = frame_cuda.compare_with_plain("surface_shade", got, want)
    if not textured:
        assert flat["ok"] and flat["pixels_over_atol"] == 0, flat
    assert frame_cuda.compare_with_plain(
        "surface_shade", (got[0], got[1] + 1.0), want, scale)["ok"] is False


# ---------------------------------------------------------------------------
# The wrappers' checks: a bad input raises on every device, before routing
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_inputs(grid_path):
    tm, txf, tnm = _mesh(grid_path, False)
    with pytest.raises(ValueError):
        frame_cuda.mesh_plan(tm, txf, CAM[:2], 200, 150)
    with pytest.raises(ValueError):
        frame_cuda.mesh_plan(tm, txf[:, :2], CAM, 200, 150)
    with pytest.raises(ValueError):
        frame_cuda.mesh_plan(tm, txf, CAM, 0, 150)
    bad = types.SimpleNamespace(**{**vars(tm), "inst_id": tm.inst_id.int()})
    with pytest.raises(ValueError):
        frame_cuda.mesh_plan(bad, txf, CAM, 200, 150)
    plan = frame_cuda.mesh_plan(tm, txf, CAM, 200, 150)
    hits = mesh_cuda.raycast_tiled(plan["tri_scalars"], plan["o"], plan["d"],
                                   plan["tile_lists"], plan["tile_counts"])
    with pytest.raises(ValueError):
        frame_cuda.surface_shade(tm, plan, hits, tnm, LIGHT, CAM, 200, 150, 3)
    with pytest.raises(ValueError):
        frame_cuda.surface_shade(tm, plan, (hits[0], hits[1].long()) + hits[2:],
                                 tnm, LIGHT, CAM, 200, 150, 2)
    with pytest.raises(ValueError):
        frame_cuda.surface_shade(tm, plan, (hits[0][:-1],) + hits[1:], tnm,
                                 LIGHT, CAM, 200, 150, 2)
    with pytest.raises(ValueError):
        frame_cuda.finalize(torch.zeros(12, 4), torch.zeros(12), 4, 4, False)
    with pytest.raises(ValueError):
        frame_cuda.finalize(torch.zeros(16, 4, dtype=torch.float64),
                            torch.zeros(16), 4, 4, False)
    scale, kw, surf, tsurf, coarse = ray_case("flash")
    occ = np.ones((1, 128, 128, 128), np.uint8)
    scene = trm.make_scene(occ, np.zeros(3), np.ones(3), np.eye(3),
                           np.zeros(3), np.ones(3))
    opts = trm.frame_options(trm.MarchOptions(
        config=NGPConfig(**CFG, aabb_scale=scale), **kw))
    s, ts = torch.as_tensor(surf), torch.as_tensor(tsurf)
    for args in (dict(surface_rgba=s),                      # alone
                 dict(surface_rgba=s[:-1], t_surface=ts),   # short
                 dict(coarse=(torch.as_tensor(coarse[0])[:-1],
                              torch.as_tensor(coarse[1])[:-1])),
                 dict(coarse=(torch.as_tensor(coarse[0]),
                              torch.as_tensor(coarse[1]).float()))):
        with pytest.raises(ValueError):
            frame_cuda.ray_init(scene, opts, RCAM, RW, RH, (0.5, 0.5), **args)
    with pytest.raises(ValueError):
        frame_cuda.ray_init(scene, opts, RCAM[:, :3], RW, RH, (0.5, 0.5))
    assert not any(frame_cuda.launches.values())
    assert not any(frame_cuda.plain_on_card.values())


def test_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor a CUDA device reaches no plain
    version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        frame_cuda.finalize(torch.zeros(16, 4, device=meta),
                            torch.zeros(16, device=meta), 4, 4, False)
    mesh = types.SimpleNamespace(
        v0=torch.zeros(3, 3, device=meta), e1=torch.zeros(3, 3, device=meta),
        e2=torch.zeros(3, 3, device=meta),
        inst_id=torch.zeros(3, dtype=torch.int64, device=meta))
    with pytest.raises(ValueError):
        frame_cuda.mesh_plan(mesh, np.zeros((1, 3, 4)), CAM, 128, 64)
    scene = {"occ": torch.zeros(1, device=meta)}
    with pytest.raises(ValueError):
        frame_cuda.ray_init(scene, None, RCAM, RW, RH, (0.5, 0.5))


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("size", [(256, 128), (200, 150), (2560, 1440)])
def test_mesh_plan_on_card(grid_path, size):
    _card()
    tm, xf, _ = _mesh(grid_path, False, "cuda")
    before = frame_cuda.launches["mesh_plan"]
    out_k = frame_cuda.mesh_plan(tm, xf, CAM, *size)
    assert frame_cuda.launches["mesh_plan"] == before + 1
    out_p = frame_cuda.mesh_plan_reference(tm, xf, CAM, *size)
    r = frame_cuda.compare_with_plain("mesh_plan", out_k, out_p)
    assert r["ok"], r
    # the ray-cast's plain version on the kernel's lists, unwritten past
    # each count, finds what it finds on the plain plan's whole lists
    hits = [mesh_cuda.raycast_tiled_reference(
        out_k["tri_scalars"], out_k["o"], out_k["d"], lists,
        out_k["tile_counts"])
        for lists in (out_k["tile_lists"], out_p["tile_lists"])]
    for a, b in zip(*hits):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1, 2])
def test_mesh_pass_on_card_reads_no_idle_ray(grid_path, factor):
    """The mesh pass on the card (the tiled ray-cast and the surface shade
    kernels) through the plan kernel's plan, whose idle tiles' rays are
    unwritten, equals the pass through the same plan with those rays
    NaN and with them the plain plan's, bit for bit; the plan kernel
    left no idle tile's ray written; its busy tiles' rays, lists, counts
    and triangles hold the plain plan's under the contract."""
    _card()
    tm, xf, nm = _mesh(grid_path, True, "cuda")
    w, h = 768, 576
    n_tiles = (w // 128) * -(-h // 64)
    n_rays = n_tiles * 128 * 64
    # the plan's rays come out of the one large block the allocator holds
    # free: a block of a known pattern, freed just before (o and d take
    # its two halves; the plan's other outputs are small allocations)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marker = torch.full((2 * n_rays, 3), -3.5, device="cuda")
    del marker
    plan = frame_cuda.mesh_plan(tm, xf, CAM, w, h)
    ref = frame_cuda.mesh_plan_reference(tm, xf, CAM, w, h)
    r = frame_cuda.compare_with_plain("mesh_plan", plan, ref)
    assert r["ok"], r
    busy, idle = _idle_tiles(plan)
    assert int(busy.sum()) > 0 and int(idle.sum()) > 0
    left = [plan[k].view(n_tiles, -1, 3)[idle] for k in ("o", "d")]
    assert all(bool((x == -3.5).all()) for x in left)
    poisoned = _with_idle_rays(plan, lambda k, x: torch.full_like(x, np.nan))
    filled = _with_idle_rays(
        plan, lambda k, x: ref[k].view(n_tiles, -1, 3)[idle])
    out = []
    for p in (plan, poisoned, filled):
        hits = mesh_cuda.raycast_tiled(p["tri_scalars"], p["o"], p["d"],
                                       p["tile_lists"], p["tile_counts"])
        out.append((hits, frame_cuda.surface_shade(tm, p, hits, nm, LIGHT,
                                                   CAM, w, h, factor)))
    assert float((out[0][1][1] > 0).float().mean()) > 0.05
    for other in out[1:]:
        for a, b in zip(out[0][0] + out[0][1], other[0] + other[1]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_surface_shade_on_card(grid_path, textured, factor):
    _card()
    tm, xf, nm = _mesh(grid_path, textured, "cuda")
    w, h = 512, 384
    plan = frame_cuda.mesh_plan(tm, xf, CAM, w, h)
    hits = mesh_cuda.raycast_tiled(plan["tri_scalars"], plan["o"], plan["d"],
                                   plan["tile_lists"], plan["tile_counts"])
    before = frame_cuda.launches["surface_shade"]
    out_k = frame_cuda.surface_shade(tm, plan, hits, nm, LIGHT, CAM, w, h,
                                     factor)
    assert frame_cuda.launches["surface_shade"] == before + 1
    out_p = frame_cuda.surface_shade_reference(tm, plan, hits, nm, LIGHT, CAM,
                                               w, h, factor)
    scale = frame_cuda.shade_error_scale(tm, plan, hits, nm, LIGHT, CAM, w, h,
                                         factor)
    r = frame_cuda.compare_with_plain("surface_shade", out_k, out_p, scale)
    assert r["ok"], r
    if not textured:       # roughness 0.3-0.6: well conditioned everywhere
        assert r["pixels_over_atol"] == 0, r
    assert float((out_k[1] > 0).float().mean()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_surface", "surface", "walk", "flash"])
def test_ray_init_on_card(case):
    _card()
    scale, kw, surf, tsurf, coarse = ray_case(case)
    cfg = NGPConfig(**CFG, aabb_scale=scale)
    scene = trm.make_scene(sphere_occupancy(cfg.max_cascade), np.full(3, 0.1),
                           np.full(3, 0.9), np.eye(3), np.zeros(3),
                           np.ones(3), device="cuda")
    opts = trm.frame_options(trm.MarchOptions(config=cfg, **kw))
    args = (scene, opts, RCAM, RW, RH, (0.3, 0.7), 5,
            None if surf is None else torch.as_tensor(surf, device="cuda"),
            None if tsurf is None else torch.as_tensor(tsurf, device="cuda"),
            None if coarse is None else tuple(torch.as_tensor(x, device="cuda")
                                              for x in coarse))
    before = frame_cuda.launches["ray_init"]
    plain = dict(frame_cuda.plain_on_card)
    out_k = frame_cuda.ray_init(*args, make_list=True)
    assert frame_cuda.launches["ray_init"] == before + (2 if case == "walk"
                                                        else 1)
    assert frame_cuda.plain_on_card == plain
    out_p = frame_cuda.ray_init_reference(*args, make_list=True)
    assert frame_cuda.plain_on_card["ray_init"] == plain["ray_init"] + 1
    r = frame_cuda.compare_with_plain("ray_init", out_k, out_p,
                                      walk=case == "walk")
    assert r["ok"], r
    # given rays (another camera model): the same kernel, not the plain
    # version
    rays = (out_p[0]["o"], out_p[0]["d"])
    before = frame_cuda.launches["ray_init"]
    out_g = frame_cuda.ray_init(*args, make_list=True, rays=rays)
    assert frame_cuda.launches["ray_init"] == before + (2 if case == "walk"
                                                        else 1)
    assert frame_cuda.plain_on_card["ray_init"] == plain["ray_init"] + 1
    r = frame_cuda.compare_with_plain("ray_init", out_g, out_p,
                                      walk=case == "walk")
    assert r["ok"], r


def _ray_init_args(case, device):
    scale, kw, surf, tsurf, coarse = ray_case(case)
    cfg = NGPConfig(**CFG, aabb_scale=scale)
    scene = trm.make_scene(sphere_occupancy(cfg.max_cascade), np.full(3, 0.1),
                           np.full(3, 0.9), np.eye(3), np.zeros(3),
                           np.ones(3), device=device)
    opts = trm.frame_options(trm.MarchOptions(config=cfg, **kw))

    def t(x):
        return None if x is None else torch.as_tensor(x, device=device)
    return (scene, opts, RCAM, RW, RH, (0.3, 0.7), 5, t(surf), t(tsurf),
            None if coarse is None else tuple(t(x) for x in coarse))


def _holds_state(out, st, first):
    """ray_init's result lies in `out`'s buffers."""
    assert all(st[k].data_ptr() == out[k].data_ptr() for k in st)
    assert first[0].data_ptr() == out["ids"].data_ptr()
    assert first[1].data_ptr() == out["n_ids"].data_ptr()


def _same_init(got, want):
    (sg, fg), (sw, fw) = got, want
    for k in sw:
        a, b = sg[k], sw[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    n = int(fw[1])
    assert int(fg[1]) == n
    assert torch.equal(torch.sort(fg[0][:n]).values,
                       torch.sort(fw[0][:n]).values)


@pytest.mark.parametrize("given", [False, True], ids=["camera", "rays"])
@pytest.mark.parametrize("case", ["no_surface", "surface", "walk", "flash"])
def test_ray_init_writes_into_given_buffers(case, given):
    """ray_init with `out` (frame_cuda.state_buffers, holding other values
    first): the state and first list of the call without it, bit for
    bit, in those buffers; given rays and surface payloads copied in."""
    args = _ray_init_args(case, "cpu")
    want = frame_cuda.ray_init(*args, make_list=True)
    kw = {"rays": (want[0]["o"].clone(), want[0]["d"].clone())} if given \
        else {}
    out = frame_cuda.state_buffers(RW * RH, "cpu")
    for v in out.values():
        v.fill_(3)
    got = frame_cuda.ray_init(*args, make_list=True, out=out, **kw)
    _holds_state(out, *got)
    _same_init(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [False, True], ids=["srgb", "linear"])
def test_finalize_on_card(linear):
    _card()
    g = torch.Generator().manual_seed(9)
    h, w = 720, 1280
    rgba = torch.rand(h * w, 4, generator=g)
    rgba[::7, 3] = 0.0005
    rgba[::11, 3] = 0.1
    depth = torch.rand(h * w, generator=g) * 3
    args = (rgba.cuda(), depth.cuda(), w, h, linear)
    out_k = frame_cuda.finalize(*args)
    out_p = frame_cuda.finalize_reference(*args)
    r = frame_cuda.compare_with_plain("finalize", out_k, out_p)
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("floor", [False, True], ids=["exact", "floor"])
def test_march_frame_impl_launches_the_frame_kernels(floor):
    """march_frame_impl on the card (each rank's march) starts with the
    ray init kernel on its given rays and ends with the finalize kernel,
    no plain version on the card, and gives the frame of the plain state."""
    _card()
    cfg = NGPConfig(n_levels=4, log2_hashmap_size=11, base_resolution=16,
                    per_level_scale=1.5)
    net = init_params(cfg, torch.Generator().manual_seed(0))
    net.grid.copy_(torch.rand(net.grid.shape,
                              generator=torch.Generator().manual_seed(1))
                   - 0.5)
    net.density_mlp[-1].mul_(100.0)      # some rays saturate
    net = net.to("cuda")
    scene = trm.make_scene(sphere_occupancy(0), np.full(3, 0.1),
                           np.full(3, 0.9), np.eye(3), np.zeros(3),
                           np.ones(3), device="cuda")
    opts = trm.MarchOptions(config=cfg, jitter=False,
                            compute_dtype="float32")
    _, _, surf, t_surf, _ = ray_case("surface")
    o, d = (torch.as_tensor(x, device="cuda")
            for x in trm.camera_rays(RCAM, RW, RH))
    surf, t_surf = (torch.as_tensor(x, device="cuda") for x in (surf, t_surf))
    kw = {}
    if floor:
        g = torch.Generator().manual_seed(4)
        n = o.shape[0]
        kw = {"t_floor": (torch.rand(n, generator=g) * 0.5).cuda(),
              "alive_mask": (torch.rand(n, generator=g) < 0.7).cuda()}
    launches = dict(frame_cuda.launches)
    plain = dict(frame_cuda.plain_on_card)
    out, epochs = trm.march_frame_impl(net, scene, o, d, surf, t_surf, opts,
                                       **kw)
    for k in ("ray_init", "finalize"):
        assert frame_cuda.launches[k] == launches[k] + 1, k
    assert frame_cuda.plain_on_card == plain
    fopts = trm.frame_options(opts)
    st = trm._make_state(scene, o, d, surf, t_surf, fopts, 0,
                         kw.get("t_floor"), kw.get("alive_mask"))
    st, want_epochs = trm.march_state(net, scene, st, fopts)
    want = trm._finalize(st)
    assert epochs == want_epochs
    for k in ("rgba", "depth"):
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_card_wrappers_raise_on_bad_inputs():
    """A CUDA tensor the kernel does not take raises, and no plain version
    runs in its place."""
    _card()
    before = dict(frame_cuda.plain_on_card)
    with pytest.raises(ValueError):
        frame_cuda.finalize(torch.zeros(16, 4, device="cuda", dtype=torch.float64),
                            torch.zeros(16, device="cuda"), 4, 4, False)
    with pytest.raises(ValueError):
        frame_cuda.finalize(torch.zeros(16, 4, device="cuda"),
                            torch.zeros(16), 4, 4, False)
    assert frame_cuda.plain_on_card == before


def test_plan_and_shade_contracts():
    """The mesh plan's lists are held to each tile's count (the kernel
    writes nothing past it) and no further; the surface colour with no
    rounding scale (an untextured mesh) flat at SHADE_ATOL on every
    pixel."""
    g = torch.Generator().manual_seed(2)
    lists = torch.stack([torch.randperm(50, generator=g) for _ in range(6)])
    counts = torch.tensor([0, 3, 50, 7, 1, 20], dtype=torch.int32)
    plan = {"tile_lists": lists.int(), "tile_counts": counts,
            "o": torch.zeros(6 * 4, 3), "d": torch.ones(6 * 4, 3),
            "tri_scalars": torch.ones(50, 9)}
    tail = {**plan, "tile_lists": plan["tile_lists"].clone()}
    tail["tile_lists"][1, 3:] = -7
    assert frame_cuda.compare_with_plain("mesh_plan", tail, plan)["ok"]
    # rays: those of the tiles with candidates (tile 0 has none)
    idle = {**plan, "d": plan["d"].clone()}
    idle["d"][:4] = np.nan
    assert frame_cuda.compare_with_plain("mesh_plan", idle, plan)["ok"]
    ray = {**plan, "d": plan["d"].clone()}
    ray["d"][5, 2] += 1e-3
    r = frame_cuda.compare_with_plain("mesh_plan", ray, plan)
    assert not r["ok"] and r["max_ray_err"] > 1e-4
    head = {**plan, "tile_lists": plan["tile_lists"].clone()}
    head["tile_lists"][3, 6] = -7
    r = frame_cuda.compare_with_plain("mesh_plan", head, plan)
    assert not r["ok"] and r["list_rows_differing"] == 1
    short = {**plan, "tile_counts": counts + (torch.arange(6) == 4).int()}
    assert not frame_cuda.compare_with_plain("mesh_plan", short, plan)["ok"]
    colour = torch.rand(16, 16, 4, generator=g)
    depth = torch.rand(16, 16, generator=g)
    assert frame_cuda.compare_with_plain(
        "surface_shade", (colour + 0.9e-5, depth), (colour, depth))["ok"]
    bumped = colour.clone()
    bumped[3, 4, 1] += 2e-5
    r = frame_cuda.compare_with_plain("surface_shade", (bumped, depth),
                                      (colour, depth))
    assert not r["ok"] and r["pixels_over_atol"] == 1
    r = frame_cuda.compare_with_plain("surface_shade", (bumped, depth),
                                      (colour, depth),
                                      torch.zeros_like(colour))
    assert r["ok"] and r["pixels_off"] == 1


def test_ray_init_contract_allows_a_few_walked_rays():
    """compare_with_plain's ray init contract: where the init walk ran, a
    few rays whose walk ended a step apart pass, as many as its
    allowance; one more, a step too far or a changed direction fails;
    with no walk no ray may differ, and no flag may flip in either."""
    scale, kw, surf, tsurf, _ = ray_case("surface")
    scene = trm.make_scene(sphere_occupancy(0), np.full(3, 0.1),
                           np.full(3, 0.9), np.eye(3), np.zeros(3),
                           np.ones(3))
    opts = trm.frame_options(trm.MarchOptions(
        config=NGPConfig(**CFG, aabb_scale=scale), **kw))
    args = (scene, opts, RCAM, RW, RH, (0.5, 0.5), 1, torch.as_tensor(surf),
            torch.as_tensor(tsurf))
    want = frame_cuda.ray_init(*args, make_list=True)
    allowed = frame_cuda.compare_with_plain("ray_init", want, want,
                                            walk=True)["allowed"]
    assert allowed >= 4
    assert frame_cuda.compare_with_plain("ray_init", want, want)["allowed"] == 0

    def moved(k, rays, by, key="t", walk=True):
        st = {n: x.clone() for n, x in want[0].items()}
        if key == "alive":
            st["alive"][rays] = ~st["alive"][rays]
        else:
            st[key][rays] = st[key][rays] + by
        return frame_cuda.compare_with_plain("ray_init", (st, want[1]), want,
                                             walk=walk)

    live = torch.nonzero(want[0]["alive"]).squeeze(1)    # a finite t
    assert moved("t", live[:allowed], 0.01)["ok"]
    assert not moved("t", live[:allowed + 1], 0.01)["ok"]
    assert not moved("t", live[:1], 10.0)["ok"]              # past a step
    assert not moved("d", live[:1], 1e-3, key="d")["ok"]
    assert not moved("t", live[:1], 0.01, walk=False)["ok"]
    for walk in (True, False):
        r = moved("alive", live[:1], 0, key="alive", walk=walk)
        assert not r["ok"] and r["alive_mismatches"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True], ids=["camera", "rays"])
@pytest.mark.parametrize("case", ["no_surface", "surface", "walk", "flash"])
def test_ray_init_into_given_buffers_on_card(case, given):
    """The ray init kernel writing into given buffers (the list route's
    cached state; the surface payloads copied by the kernel, given rays
    by two copies): bit for bit its own state and the same first list
    without them, the same launches."""
    _card()
    args = _ray_init_args(case, "cuda")
    want = frame_cuda.ray_init(*args, make_list=True)
    kw = {"rays": (want[0]["o"].clone(), want[0]["d"].clone())} if given \
        else {}
    out = frame_cuda.state_buffers(RW * RH, "cuda")
    for v in out.values():
        v.fill_(3)
    before = frame_cuda.launches["ray_init"]
    got = frame_cuda.ray_init(*args, make_list=True, out=out, **kw)
    torch.cuda.synchronize()
    assert frame_cuda.launches["ray_init"] == before + (2 if case == "walk"
                                                        else 1)
    _holds_state(out, *got)
    _same_init(got, want)

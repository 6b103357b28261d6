"""The mesh ray-cast wrappers and their CUDA kernels (tiled and untiled).

The kernels run only on an NVIDIA GPU with nvcc; those tests carry the
`cuda` marker and skip elsewhere (run them on the card with
`python -m pytest tests/test_torch_kernel.py -m cuda`). There each kernel
is held against its plain PyTorch version under the contract of
`mesh_cuda.compare_with_plain`: rays whose hit mask or id differ number at
most max(4, ceil(1e-4 x hits)); where the ids agree, |dt| <= 1e-5
max(1, t) and |du|, |dv| <= 1e-5 (csrc/mesh_raycast.cu says why the
contract is looser than bit for bit). The CPU tests here hold a model of
the kernels' design to the plain version: the fused filter, emulated in
float64 below, passes every hit the plain version accepts, at any
distance; and the chunked key merge equals the ascending walk. The model
is this file's copy of csrc/mesh_raycast.cu's arithmetic; the `cuda`
tests hold the kernels themselves. This file imports only torch and the
port, so it also collects where the repository's test helpers do not
import.
"""

import pytest
import torch

from nerf_glasses_tpu_torch.ops import mesh_cuda

torch.set_num_threads(1)


def _inputs(n_tris, n_tiles, tile_rays, seed=0, device="cpu"):
    """Random triangles (both windings) around the origin, rays from z=2
    toward them, per-tile ascending candidate lists with counts from 0 to
    n_tris."""
    g = torch.Generator().manual_seed(seed)
    v0 = torch.rand(n_tris, 3, generator=g) - 0.5
    e1 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.3
    e2 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.3
    # triangle 0 faces the rays and covers a part of them
    v0[0], e1[0], e2[0] = (torch.tensor([-0.5, -0.5, 0.0]),
                           torch.tensor([1.0, 0.0, 0.0]),
                           torch.tensor([0.0, 1.0, 0.0]))
    o = torch.zeros(n_tiles * tile_rays, 3)
    o[:, 2] = 2.0
    d = torch.randn(n_tiles * tile_rays, 3, generator=g) * 0.25
    d[:, 2] = -1.0
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    counts = torch.randint(0, n_tris + 1, (n_tiles,), generator=g,
                           dtype=torch.int32)
    counts[0], counts[-1] = 0, n_tris
    lists = torch.sort(torch.stack([torch.randperm(n_tris, generator=g)
                                    for _ in range(n_tiles)]), dim=1).values
    return [x.to(device).contiguous() for x in
            (torch.cat([v0, e1, e2], 1), o, d, lists.int(), counts)]


def _far_inputs(dist=1.5, n_tris=600, n_rays=4096, seed=3):
    """Small triangles (edges ~0.01) facing a camera `dist` away, as the
    glasses face the smoke camera at 1.5: the fused products cancel
    here, the more the farther."""
    g = torch.Generator().manual_seed(seed)
    v0 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.2
    e1 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.02
    e2 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.02
    o = torch.tensor([0.3 * dist / 1.5, -0.2 * dist / 1.5, dist])
    o = o.expand(n_rays, 3).contiguous()
    aim = (torch.rand(n_rays, 3, generator=g) - 0.5) * 0.2
    d = aim - o
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.cat([v0, e1, e2], 1), o, d.contiguous()


def _shared_edge_inputs(n_rays=2048, device="cpu"):
    """Two front-facing triangles of one quad, sharing the edge from
    (0.5, -0.5) to (-0.5, 0.5), and rays from z=2 aimed at points on that
    edge (a tie in t is likely), listed as one tile."""
    g = torch.Generator().manual_seed(5)
    p = torch.tensor([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0],
                      [-0.5, 0.5, 0.0], [0.5, 0.5, 0.0]])
    a, b = (p[0], p[1], p[2]), (p[1], p[3], p[2])
    tri = torch.stack([torch.cat([x0, x1 - x0, x2 - x0]) for x0, x1, x2 in (a, b)])
    s = torch.rand(n_rays, 1, generator=g)
    aim = p[1] + s * (p[2] - p[1])
    o = torch.tensor([0.0, 0.0, 2.0]) + (torch.rand(n_rays, 3, generator=g)
                                         - 0.5) * 0.5
    d = aim - o
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    lists = torch.tensor([[0, 1]], dtype=torch.int32)
    counts = torch.tensor([2], dtype=torch.int32)
    return [x.to(device).contiguous() for x in (tri, o, d, lists, counts)]


# ---------------------------------------------------------------------------
# A model of the kernels' filter (may_hit, load_ray and pack_tris in
# csrc/mesh_raycast.cu): each __fmaf_rn is taken in float64 from f32
# operands (the product is exact there) and rounded once to f32, which
# equals the card's fused result but for rare double roundings.
# ---------------------------------------------------------------------------

FILTER_UV = float(torch.tensor(1e-5) + 2.0 ** -7)     # 1e-5f + 0.0078125f
FILTER_ABS = 2.0 ** -21
FILTER_T_SCALE = 1.0 + 2.0 ** -10


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _fused_products(o, d, tri):
    """(det, u*det, v*det, t*det) f32 in the kernels' form, with m = e2 x
    e1 as pack_tris stores it: det = d.m, u*det = s.e2, v*det = -s.e1
    and t*det = -t.m for t = o - v0, s = t x d."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    mx = _fma(e2y, e1z, -(e2z * e1y))
    my = _fma(e2z, e1x, -(e2x * e1z))
    mz = _fma(e2x, e1y, -(e2y * e1x))
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    sx = _fma(ty, dz, -(tz * dy))
    sy = _fma(tz, dx, -(tx * dz))
    sz = _fma(tx, dy, -(ty * dx))
    det = _fma(dz, mz, _fma(dy, my, dx * mx))
    un = _fma(sz, e2z, _fma(sy, e2y, sx * e2x))
    sv = _fma(sz, e1z, _fma(sy, e1y, sx * e1x))
    tm = _fma(tz, mz, _fma(ty, my, tx * mx))
    return det, un, -sv, -tm


def _ray_tol(o, tri):
    """load_ray's margin: FILTER_ABS x the ray's reach over the box of
    the v0 (the largest |o - v0| on an axis) x the mesh's largest
    |e1|_1 + |e2|_1, as pack_tris reduces them."""
    v0 = tri[:, :3]
    lo, hi = v0.min(0).values, v0.max(0).values
    reach = torch.maximum(o - lo, hi - o).max(-1).values
    extent = (tri[:, 3:6].abs().sum(-1) + tri[:, 6:9].abs().sum(-1)).max()
    return FILTER_ABS * reach * extent


def _fused_filter(det, un, vn, tn, lim, ray_tol):
    """may_hit's tests, with lim = best t x FILTER_T_SCALE (BIG x
    FILTER_T_SCALE before any hit) and tol = FILTER_UV det + ray_tol."""
    tol = _fma(torch.tensor(FILTER_UV), det, ray_tol)
    return ((un >= -tol) & (vn >= -tol) & (un + vn <= det + tol)
            & (tn < det * lim))


def _all_pairs(tri, o, d):
    """Every ray against every triangle: the plain test's (t, u, v, hit),
    the fused products and each ray's margin (one column)."""
    t, u, v, hit = mesh_cuda._moller_trumbore(o[:, None], d[:, None], tri[None])
    return ((t, u, v, hit), _fused_products(o[:, None], d[:, None], tri[None]),
            _ray_tol(o, tri)[:, None])


def test_cpu_tensors_take_the_plain_version():
    args = _inputs(40, 3, 64)
    before = mesh_cuda.launches
    t, i, u, v = mesh_cuda.raycast_tiled(*args)
    assert mesh_cuda.launches == before
    assert (i >= 0).sum() > 0 and i.dtype == torch.int32
    assert (t[i < 0] == mesh_cuda.BIG).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _inputs(40, 3, 64)
    with pytest.raises(ValueError):
        mesh_cuda.raycast_tiled(*(a.to("meta") for a in args))


# ---------------------------------------------------------------------------
# The kernels' design, emulated on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["random", "far_small", "shared_edge"])
def test_fused_filter_passes_every_plain_hit(scene):
    """may_hit (fused products, det-scaled tests with margins) passes
    every (ray, triangle) the plain test accepts, also with lim set just
    above that hit's own t, so the kernels' exact second step sees every
    candidate the plain walk could keep; and it drops nearly all others."""
    if scene == "random":
        tri, o, d, _, _ = _inputs(200, 1, 2048)
    elif scene == "far_small":
        tri, o, d = _far_inputs()
    else:
        tri, o, d, _, _ = _shared_edge_inputs()
    (t, _, _, hit), (det, un, vn, tn), tol = _all_pairs(tri, o, d)
    assert int(hit.sum()) > 100
    lim = (t * FILTER_T_SCALE).float()
    passed = _fused_filter(det, un, vn, tn, lim, tol)
    assert bool(passed[hit].all())
    loose = _fused_filter(det, un, vn, tn, mesh_cuda.BIG, tol)
    assert int(loose.sum()) <= 1.2 * int(hit.sum()) + 16


@pytest.mark.parametrize("ratio", [150, 1500, 15000, 150000])
def test_filter_margin_follows_the_distance(ratio):
    """The same triangles (edges ~0.01) seen from `ratio` times their
    size: the filter's margin grows with the distance, as the fused
    products' rounding error does, so it passes every plain hit at every
    distance, and passes at most 2% of all tests at the farthest."""
    tri, o, d = _far_inputs(dist=0.01 * ratio)
    (t, _, _, hit), (det, un, vn, tn), tol = _all_pairs(tri, o, d)
    assert int(hit.sum()) > 100
    lim = (t * FILTER_T_SCALE).float()
    assert bool(_fused_filter(det, un, vn, tn, lim, tol)[hit].all())
    loose = _fused_filter(det, un, vn, tn, mesh_cuda.BIG, tol)
    assert int(loose.sum()) <= 0.02 * loose.numel()


def test_det_only_margin_drops_far_hits():
    """Why the margin has a term that grows with the distance: with
    FILTER_UV det alone, the filter drops plain hits once the camera is
    1.5e5 times the triangles' size away."""
    tri, o, d = _far_inputs(dist=1500.0)
    (t, _, _, hit), (det, un, vn, tn), _ = _all_pairs(tri, o, d)
    lim = (t * FILTER_T_SCALE).float()
    dropped = hit & ~_fused_filter(det, un, vn, tn, lim, torch.zeros(()))
    assert int(dropped.sum()) > 0


def test_fused_products_alone_miss_the_contract():
    """Why the kernels recompute a passing candidate with the plain
    arithmetic: on small triangles seen from afar, u and v taken from the
    fused products stray beyond the contract's 1e-5."""
    tri, o, d = _far_inputs()
    (t, u, v, hit), (det, un, vn, tn), _ = _all_pairs(tri, o, d)
    du = ((un / det) - u)[hit].abs().max()
    dv = ((vn / det) - v)[hit].abs().max()
    assert max(float(du), float(dv)) > mesh_cuda.UV_TOL


def _unpack_hit_keys(keys):
    """Inverse of mesh_cuda.pack_hit_keys -> (t f32, id i32)."""
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    low = keys & 0xFFFFFFFF
    return t, torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)


def test_pack_hit_keys_orders_as_t_then_id():
    g = torch.Generator().manual_seed(2)
    t = torch.rand(500, generator=g) * 3.0 + 1e-4
    t[250:] = t[:250]                                  # ties in t
    idx = torch.randint(0, 1 << 20, (500,), generator=g, dtype=torch.int32)
    t = torch.cat([t, torch.tensor([mesh_cuda.BIG])]).float()
    idx = torch.cat([idx, torch.tensor([-1], dtype=torch.int32)])
    keys = mesh_cuda.pack_hit_keys(t, idx)
    order = torch.argsort(keys)
    lex = sorted(range(len(t)), key=lambda k: (float(t[k]), int(idx[k]) & 0xFFFFFFFF))
    assert order.tolist() == lex
    assert int(order[-1]) == len(t) - 1                # the miss is largest
    t2, i2 = _unpack_hit_keys(keys)
    assert torch.equal(t2, t) and torch.equal(i2, idx)


def _chunk_merged(tri, o, d, lists, counts, chunk):
    """The tiled kernel's merge, emulated: each chunk of every list walked
    alone (its first minimum), packed as hit keys, the minimum key across
    chunks, then u and v recomputed for the winning triangle."""
    miss = mesh_cuda.pack_hit_keys(torch.tensor([mesh_cuda.BIG]).float(),
                                   torch.tensor([-1], dtype=torch.int32))
    keys = miss.expand(o.shape[0]).clone()
    for s in range(0, lists.shape[1], chunk):
        c = torch.clamp(counts - s, 0, chunk).int()
        if int(c.max()) == 0:
            break
        pt, pi, _, _ = mesh_cuda.raycast_tiled_reference(
            tri, o, d, lists[:, s:s + chunk].contiguous(), c)
        keys = torch.minimum(keys, mesh_cuda.pack_hit_keys(pt, pi))
    t, idx = _unpack_hit_keys(keys)
    hit = idx >= 0
    tw, uw, vw, _ = mesh_cuda._moller_trumbore(o[hit], d[hit],
                                               tri[idx[hit].long()])
    assert torch.equal(tw, t[hit])
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    u[hit], v[hit] = uw, vw
    return t, idx, u, v


@pytest.mark.parametrize("chunk", [1, 5, 16, 128])
def test_chunked_key_merge_equals_the_walk(chunk):
    """The smallest hit key over a list's chunks is the strict-`<`
    ascending walk's answer, bit for bit, ties at equal t included: three
    copies of triangle 0 sit at ids 7, 20 and 33, in other chunks."""
    tri, o, d, lists, counts = _inputs(40, 4, 256, seed=4)
    for k in (7, 20, 33):
        tri[k] = tri[0]
    lists[1] = torch.arange(40, dtype=torch.int32)
    counts[1] = 40
    ref = mesh_cuda.raycast_tiled_reference(tri, o, d, lists, counts)
    got = _chunk_merged(tri, o, d, lists, counts, chunk)
    assert int((ref[1] >= 0).sum()) > 50
    tied = (ref[1] == 0).view(4, 256)[1]
    assert int(tied.sum()) > 10                        # id 0 beat its copies
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _out(n, hits=100):
    t = torch.full((n,), mesh_cuda.BIG)
    i = torch.full((n,), -1, dtype=torch.int32)
    t[:hits] = torch.linspace(1.0, 2.0, hits)
    i[:hits] = torch.arange(hits, dtype=torch.int32)
    u = torch.zeros(n)
    v = torch.zeros(n)
    u[:hits], v[:hits] = 0.25, 0.5
    return [t, i, u, v]


@pytest.mark.parametrize("case,ok", [
    ("equal", True), ("four_ids_moved", True), ("five_ids_moved", False),
    ("hit_lost", True), ("du_past", False), ("dt_within", True),
    ("dt_past", False)])
def test_compare_with_plain_applies_the_contract(case, ok):
    plain = _out(1000)
    kern = [x.clone() for x in plain]
    if case == "four_ids_moved":
        kern[1][:4] += 1
    elif case == "five_ids_moved":
        kern[1][:5] += 1
    elif case == "hit_lost":
        kern[0][3], kern[1][3] = mesh_cuda.BIG, -1
    elif case == "du_past":
        kern[2][10] += 2e-5
    elif case == "dt_within":
        kern[0][10] *= 1.0 + 0.9e-5
    elif case == "dt_past":
        kern[0][10] *= 1.0 + 2e-5
    r = mesh_cuda.compare_with_plain(kern, plain)
    assert r["ok"] is ok
    assert r["hits"] == 100 and r["allowed"] == 4
    if case == "equal":
        assert r["id_mismatches"] == 0 and r["max_abs_err"] == 0.0
    if case == "hit_lost":
        assert r["mask_mismatches"] == 1 and r["id_mismatches"] == 1


# ---------------------------------------------------------------------------
# The tiled kernel on the card
# ---------------------------------------------------------------------------

def _check_on_card(kernel, reference, args, counter):
    before = getattr(mesh_cuda, counter)
    out_k = kernel(*args)
    torch.cuda.synchronize()
    assert getattr(mesh_cuda, counter) == before + 1
    out_p = reference(*args)
    r = mesh_cuda.compare_with_plain(out_k, out_p)
    assert r["ok"], r
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 40, 8192), (500, 7, 1000), (1, 2, 256)],
                         ids=["main_path_tiles", "partial_blocks", "one_triangle"])
def test_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    args = _inputs(*shape, device="cuda")
    r = _check_on_card(mesh_cuda.raycast_tiled,
                       mesh_cuda.raycast_tiled_reference, args, "launches")
    assert r["hits"] > 0


@pytest.mark.cuda
def test_kernel_tile_of_several_chunks_on_card():
    """Counts of 0, 1, one chunk, one chunk + 1 and many chunks in one
    call: the one-pass tiles, the atomic merge and the empty tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    args = _inputs(1000, 6, 8192, seed=6)
    args[4] = torch.tensor([0, 1, 128, 129, 1000, 517], dtype=torch.int32)
    args = [a.to("cuda") for a in args]
    r = _check_on_card(mesh_cuda.raycast_tiled,
                       mesh_cuda.raycast_tiled_reference, args, "launches")
    assert r["hits"] > 0


@pytest.mark.cuda
def test_kernel_shared_edge_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    args = _shared_edge_inputs(device="cuda")
    r = _check_on_card(mesh_cuda.raycast_tiled,
                       mesh_cuda.raycast_tiled_reference, args, "launches")
    assert r["hits"] > 1000
    r = _check_on_card(mesh_cuda.raycast, mesh_cuda.raycast_reference,
                       args[:3], "raycast_launches")
    assert r["hits"] > 1000


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    tri, o, d, lists, counts = _inputs(10, 2, 64, device="cuda")
    with pytest.raises(ValueError):
        mesh_cuda.raycast_tiled(tri, o[:-1], d[:-1], lists, counts)
    with pytest.raises(ValueError):
        mesh_cuda.raycast_tiled(tri, o, d, lists.long(), counts)


# ---------------------------------------------------------------------------
# The untiled ray-cast (raycast, kernel nmr_raycast)
# ---------------------------------------------------------------------------

def _untiled_inputs(n_tris, n_rays, seed=1, device="cpu"):
    tri, o, d, _, _ = _inputs(max(n_tris, 1), 1, n_rays, seed)
    return [x.to(device).contiguous() for x in (tri[:n_tris], o, d)]


def test_untiled_cpu_tensors_take_the_plain_version():
    args = _untiled_inputs(40, 500)
    before = mesh_cuda.raycast_launches
    t, i, u, v = mesh_cuda.raycast(*args)
    assert mesh_cuda.raycast_launches == before
    assert (i >= 0).sum() > 0 and i.dtype == torch.int32
    assert (t[i < 0] == mesh_cuda.BIG).all()
    # every ray against all triangles == one tile holding every triangle
    tile = mesh_cuda.raycast_tiled(
        *args, torch.arange(40, dtype=torch.int32)[None],
        torch.tensor([40], dtype=torch.int32))
    for a, b in zip((t, i, u, v), tile):
        assert torch.equal(a, b)


def test_untiled_wrapper_rejects_what_the_kernel_does_not_take():
    args = _untiled_inputs(40, 64)
    with pytest.raises(ValueError):
        mesh_cuda.raycast(*(a.to("meta") for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3280, 65536), (700, 1000), (1, 257),
                                   (0, 64)],
                         ids=["glasses_size", "partial_batch",
                              "one_triangle", "no_triangles"])
def test_untiled_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    args = _untiled_inputs(*shape, device="cuda")
    r = _check_on_card(mesh_cuda.raycast, mesh_cuda.raycast_reference, args,
                       "raycast_launches")
    assert r["hits"] > 0 or shape[0] == 0


@pytest.mark.cuda
def test_untiled_kernel_rejects_bad_shapes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    tri, o, d = _untiled_inputs(10, 64, device="cuda")
    with pytest.raises(ValueError):
        mesh_cuda.raycast(tri, o[:-1], d)
    with pytest.raises(ValueError):
        mesh_cuda.raycast(tri[:, :8].contiguous(), o, d)

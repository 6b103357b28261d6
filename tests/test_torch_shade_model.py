"""A model of nmr_surface_shade's work map (csrc/frame.cu
surface_shade_kernel), in numpy on the CPU, and the kernel on the card.

The model follows the kernel: the busy tiles listed from the counts in
ascending order (the block scan); the block units, the busy tiles' first
(256 threads a unit, a thread a supersampled ray, a pixel's F x F rays in
min(F^2, 32) adjacent lanes), then the frame's pixels, FILL_PIXELS a
unit; each term the ray's sRGB colour times 1 / F^2 in float32; and a
pixel's sum as its first lane takes it from its lanes: the terms of its
rays in order (fy outer, fx inner, from 0, a miss skipped). It
checks that every output pixel's colour and depth are written exactly
once, and holds the model's outputs against `surface_shade_reference`
under `frame_cuda.compare_with_plain`'s contract (the plain version sums
the block with aten's reduction, in another order; depth equal). Cases:
F = 1 and 2, a frame that is not a whole number of tiles, and no busy
tile, one, several that are not adjacent, or every tile busy. The
`cuda` case holds the kernel against the plain version on the same
cases (on the card: `python -m pytest tests/test_torch_shade_model.py -m
cuda -q`, binding tests/ first where another `tests` package shadows
it, as README says).
"""

import numpy as np
import pytest
import torch

from nerf_glasses_tpu_torch.ops import frame_cuda, mesh_cuda
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb
from tests.test_torch_frame_card import (  # noqa: F401
    CAM, LIGHT, _mesh, grid_path)

torch.set_num_threads(1)

F32 = np.float32
THREADS = 256                 # csrc/frame.cu THREADS
FILL_PIXELS = 4 * THREADS     # a block's fill unit
TILE_W, TILE_H = frame_cuda.TILE_W, frame_cuda.TILE_H
TILE_RAYS = TILE_W * TILE_H
WIDTH, HEIGHT = 500, 370      # the supersampled pass: 4 x 6 tiles, padded
CASES = ("none", "one", "several", "all")


def _case(grid_path, textured, case, device="cpu"):
    """The mesh, its plan and hits with the tiles of `case` busy: a tile
    taken out has count 0 and no hit (as the ray-cast leaves it); "all"
    gives every tile a count, a tile with no candidate then busy without
    a hit."""
    tm, xf, nm = _mesh(grid_path, textured, device)
    plan = frame_cuda.mesh_plan(tm, xf, CAM, WIDTH, HEIGHT)
    t, tri, u, v = mesh_cuda.raycast_tiled(
        plan["tri_scalars"], plan["o"], plan["d"], plan["tile_lists"],
        plan["tile_counts"])
    counts = plan["tile_counts"].cpu()
    ntx, n_tiles = plan["ntx"], counts.shape[0]
    lit = [k for k in range(n_tiles)
           if bool((tri.view(n_tiles, -1)[k] >= 0).any())]
    if case == "all":
        keep = list(range(n_tiles))
        counts = torch.clamp(counts, min=1)
    elif case == "none":
        keep = []
    elif case == "one":
        keep = lit[:1]
    else:                     # no two kept tiles side by side or stacked
        keep = []
        for k in lit:
            if all(abs(k // ntx - m // ntx) + abs(k % ntx - m % ntx) > 1
                   for m in keep):
                keep.append(k)
        assert len(keep) >= 2, lit
    on = torch.zeros(n_tiles, dtype=torch.bool)
    on[keep] = True
    if case != "all":
        counts = torch.where(on, counts, 0).int()
    tri = torch.where(on.to(tri.device).repeat_interleave(TILE_RAYS), tri,
                      -1).int()
    plan = {**plan, "tile_counts": counts.to(plan["d"].device)}
    return tm, nm, plan, (t, tri, u, v)


def shade_model(tm, nm, plan, hits, factor):
    """surface_shade_kernel's work on the CPU -> (rgba (H/F, W/F, 4),
    depth (H/F, W/F), rgba writes and depth writes a pixel, reads a
    ray)."""
    t, tri, u, v = (x.cpu() for x in hits)
    counts = plan["tile_counts"].cpu().numpy()
    ntx = plan["ntx"]
    out_w, out_h = WIDTH // factor, HEIGHT // factor
    n_out = out_w * out_h
    # the busy list and flags (the block scan, ascending)
    busy = counts > 0
    busy_list = np.nonzero(busy)[0]
    # each ray's term: its shaded colour in sRGB times 1 / F^2 (the plain
    # version's per-ray float32 operations), its hit and t
    eye = torch.as_tensor(CAM[:, 3])
    rgb = frame_cuda.shade_hits(
        tm, eye.expand(plan["d"].shape), plan["d"].cpu(), t, tri,
        torch.stack([u, v], -1), torch.as_tensor(np.asarray(nm)),
        torch.as_tensor(np.asarray(LIGHT, F32)), eye)
    term = (linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
            * np.float32(1.0 / (factor * factor))).numpy()
    hit, tt = tri.numpy() >= 0, t.numpy()
    inv_ff = F32(1.0 / (factor * factor))

    rgba = np.full((n_out, 4), np.nan, F32)
    depth = np.full(n_out, np.nan, F32)
    w_rgba = np.zeros(n_out, np.int64)
    w_depth = np.zeros(n_out, np.int64)
    reads = np.zeros(t.shape[0], np.int64)
    ff = factor * factor
    g = min(ff, 32)
    tw, th = TILE_W // factor, TILE_H // factor
    px_unit = THREADS // g
    units_tile = -(-(TILE_RAYS // ff) // px_unit)
    thr = np.arange(THREADS)

    def shade_unit(tile, unit):
        """A block: thread -> (pixel, its ray j of g); the pixel's first
        lane adds the g lanes' terms in order, g rays at a time."""
        ty, tx = divmod(int(tile), ntx)
        q = unit * px_unit + thr // g
        j = thr % g
        first = thr - j                     # the pixel's first lane
        qy, qx = q // tw, q % tw
        oy, ox = ty * th + qy, tx * tw + qx
        on = (q < tw * th) & (ox < out_w) & (oy < out_h)
        acc = np.zeros((THREADS, 4), F32)
        dmax = np.zeros(THREADS, F32)
        for i0 in range(0, ff, g):
            i = i0 + j
            fy, fx = i // factor, i % factor
            r = (int(tile) * TILE_RAYS + (qy * factor + fy) * TILE_W
                 + qx * factor + fx)
            np.add.at(reads, r[on], 1)
            r = np.where(on, r, 0)
            h = on & hit[r]
            c = np.where(h[:, None], term[r], F32(0.0))
            tk = np.where(h, tt[r], F32(0.0))
            for k in range(g):
                src = first + k
                add = h[src]
                acc[:, :3] = np.where(add[:, None], acc[:, :3] + c[src],
                                      acc[:, :3])
                acc[:, 3] = np.where(add, acc[:, 3] + inv_ff, acc[:, 3])
                keep = np.isnan(dmax) | (dmax > tk[src])     # nmax
                dmax = np.where(add & ~keep, tk[src], dmax)
        st = on & (j == 0)
        p = (oy * out_w + ox)[st]
        rgba[p] = acc[st]
        depth[p] = dmax[st]
        np.add.at(w_rgba, p, 1)
        np.add.at(w_depth, p, 1)

    def busy_px(p):
        oy, ox = p // out_w, p % out_w
        return busy[(oy * factor // TILE_H) * ntx + ox * factor // TILE_W]

    def fill_unit(p0):
        """A block: 4 rgba stores of consecutive pixels, then 4 depths a
        thread."""
        for k in range(4):
            p = p0 + k * THREADS + thr
            p = p[p < n_out]
            p = p[~busy_px(p)]
            rgba[p] = 0.0
            np.add.at(w_rgba, p, 1)
        pd = (p0 + 4 * thr[:, None] + np.arange(4)[None]).reshape(-1)
        pd = pd[pd < n_out]
        pd = pd[~busy_px(pd)]
        depth[pd] = 0.0
        np.add.at(w_depth, pd, 1)

    # the units: the busy tiles' first, then the fill (any block's)
    n_shade = busy_list.size * units_tile
    for u in range(n_shade + -(-n_out // FILL_PIXELS)):
        if u < n_shade:
            shade_unit(busy_list[u // units_tile], u % units_tile)
        else:
            fill_unit((u - n_shade) * FILL_PIXELS)
    return (torch.from_numpy(rgba.reshape(out_h, out_w, 4)),
            torch.from_numpy(depth.reshape(out_h, out_w)), w_rgba, w_depth,
            reads)


def _rays_of_output_pixels(plan, factor):
    """-> (n_rays,) bool: the rays of busy tiles that fall in a NeRF pixel
    of the output (the pass's tile padding holds more)."""
    counts = plan["tile_counts"].cpu()
    r = torch.arange(counts.shape[0] * TILE_RAYS)
    tile, p = r // TILE_RAYS, r % TILE_RAYS
    row = (tile // plan["ntx"]) * TILE_H + p // TILE_W
    col = (tile % plan["ntx"]) * TILE_W + p % TILE_W
    return ((row // factor < HEIGHT // factor)
            & (col // factor < WIDTH // factor) & (counts[tile] > 0)).numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_shade_model_writes_each_pixel_once_and_matches_plain(
        grid_path, textured, factor, case):
    tm, nm, plan, hits = _case(grid_path, textured, case)
    rgba, depth, w_rgba, w_depth, reads = shade_model(tm, nm, plan, hits,
                                                      factor)
    assert np.all(w_rgba == 1) and np.all(w_depth == 1)
    assert np.array_equal(reads, _rays_of_output_pixels(plan, factor))
    want = frame_cuda.surface_shade_reference(tm, plan, hits, nm, LIGHT, CAM,
                                              WIDTH, HEIGHT, factor)
    scale = (frame_cuda.shade_error_scale(tm, plan, hits, nm, LIGHT, CAM,
                                          WIDTH, HEIGHT, factor)
             if textured else None)
    r = frame_cuda.compare_with_plain("surface_shade", (rgba, depth), want,
                                      scale)
    assert r["ok"] and r["depth_equal"], r
    covered = int((want[1] > 0).sum())
    if case == "none":
        assert covered == 0 and not bool(rgba.any())
    else:
        assert covered > 0
    if not textured:
        assert r["pixels_over_atol"] == 0, r


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_surface_shade_kernel_cases_on_card(grid_path, textured, factor,
                                            case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    tm, nm, plan, hits = _case(grid_path, textured, case, "cuda")
    before = frame_cuda.launches["surface_shade"]
    got = frame_cuda.surface_shade(tm, plan, hits, nm, LIGHT, CAM, WIDTH,
                                   HEIGHT, factor)
    torch.cuda.synchronize()
    assert frame_cuda.launches["surface_shade"] == before + 1
    want = frame_cuda.surface_shade_reference(tm, plan, hits, nm, LIGHT, CAM,
                                              WIDTH, HEIGHT, factor)
    scale = (frame_cuda.shade_error_scale(tm, plan, hits, nm, LIGHT, CAM,
                                          WIDTH, HEIGHT, factor)
             if textured else None)
    r = frame_cuda.compare_with_plain("surface_shade", got, want, scale)
    assert r["ok"] and r["depth_equal"], r
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())

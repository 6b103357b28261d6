"""Mesh ray-casts: the CUDA kernels, their wrappers and their plain
PyTorch versions.

- `raycast_tiled` replaces nerf_glasses_tpu/ops/mesh_pallas.py::
  raycast_pallas_tiled (each ray against its screen tile's candidates;
  plain version `raycast_tiled_reference`, launches counted in
  `launches`).
- `raycast` replaces mesh_pallas.py::raycast_pallas (each ray against all
  triangles; plain version `raycast_reference`, launches counted in
  `raycast_launches`).

On a CUDA tensor a wrapper launches its hand-written kernel in
csrc/mesh_raycast.cu (built with nvcc for sm_90a at first use, into
`_build/`, keyed by a hash of the source and flags) or raises; on a CPU
tensor it runs its plain version. There is no fallback from one to the
other.

Numerics: the kernels test each candidate with fused products and
margins that follow their rounding error, and take the plain version's
own arithmetic only for the few that pass (the head of
csrc/mesh_raycast.cu says why). `compare_with_plain` holds a kernel's
output to the contract: rays whose hit mask or id differ number at most
max(4, ceil(1e-4 x hits)); where the ids agree, |dt| <= 1e-5 max(1, t)
and |du|, |dv| <= 1e-5.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from nerf_glasses_tpu_torch.ops import cuda_build

BIG = 1e16

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "mesh_raycast.cu")
# The kernels spell out every rounding with intrinsics, so no flag
# changes their results.
NVCC_FLAGS = cuda_build.ARCH_FLAGS

# The kernel-vs-plain contract (compare_with_plain).
MISMATCH_FRACTION = 1e-4
MISMATCH_MIN = 4
T_REL_TOL = 1e-5
UV_TOL = 1e-5

# Kernel launches made by raycast_tiled and by raycast (CUDA tensors only).
launches = 0
raycast_launches = 0

_lib = None
build_log = ""
build_seconds = 0.0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    lib, build_log, build_seconds = cuda_build.build_library(_SOURCE,
                                                             NVCC_FLAGS)
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    _lib = cuda_build.declare(lib, (
        ("nmr_raycast_tiled", [p, i, p, p, p, p, i, i, i, p, p, p, p, p, p], i),
        ("nmr_raycast_tiled_scratch", [i, i, i, i], ll),
        ("nmr_raycast", [p, p, p, i, ll, p, p, p, p, p, p], i),
        ("nmr_raycast_scratch", [i], ll)))
    return _lib


def _moller_trumbore(o, d, tri):
    """Back-face-culled Moller-Trumbore. o, d (..., 3) broadcast against
    tri (..., 9) = [v0 | e1 | e2] -> (t, u, v, hit) without the running
    best-t test; operation order as in the kernel."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    valid = det > 1e-9
    inv = torch.reciprocal(torch.where(valid, det, 1.0))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (valid & (u >= -1e-5) & (v >= -1e-5) & (u + v <= 1.0 + 1e-5)
           & (t > 1e-4))
    return t, u, v, hit


def pack_hit_keys(t, idx):
    """(t f32, id i32) -> int64 keys that order as (t, then id): t's bits
    in the high word (t > 0, so they order as integers), the id as an
    unsigned word in the low one (a miss, id -1 with t = 1e16, is the
    largest key). Mirrors hit_key in csrc/mesh_raycast.cu, whose tiled
    kernel merges chunks with a 64-bit atomicMin on these keys."""
    return ((t.contiguous().view(torch.int32).to(torch.int64) << 32)
            | (idx.to(torch.int64) & 0xFFFFFFFF))


def compare_with_plain(out_k, out_p) -> dict:
    """A kernel's (t, idx, u, v) against its plain version's on the same
    rays -> counts, worst differences and `ok` under the contract: rays
    whose hit mask or id differ number at most max(MISMATCH_MIN,
    ceil(MISMATCH_FRACTION x plain hits)); on rays whose ids agree,
    |dt| <= T_REL_TOL max(1, t) and |du|, |dv| <= UV_TOL."""
    kt, ki, ku, kv = out_k
    pt, pi, pu, pv = out_p
    hits = int((pi >= 0).sum())
    agree = ki == pi
    mask_diff = int(((ki >= 0) != (pi >= 0)).sum())
    id_diff = int((~agree).sum())
    allowed = max(MISMATCH_MIN, math.ceil(MISMATCH_FRACTION * hits))

    def worst(x):
        return float(x[agree].abs().max()) if bool(agree.any()) else 0.0

    dt = worst(kt - pt)
    dt_rel = worst((kt - pt) / torch.clamp(pt.abs(), min=1.0))
    du, dv = worst(ku - pu), worst(kv - pv)
    ok = (id_diff <= allowed and dt_rel <= T_REL_TOL and du <= UV_TOL
          and dv <= UV_TOL)
    return {"hits": hits, "mask_mismatches": mask_diff,
            "id_mismatches": id_diff, "allowed": allowed, "max_dt": dt,
            "max_dt_rel": dt_rel, "max_du": du, "max_dv": dv,
            "max_abs_err": max(dt, du, dv), "ok": ok}


def raycast_tiled_reference(tri_scalars, o, d, tile_lists, tile_counts,
                            chunk: int = 32):
    """Plain PyTorch version of the kernel: each tile's candidates are
    gathered (padded to the largest count and masked) and tested
    `chunk` at a time; the first minimum in list order wins, as in the
    kernel's strict `<` walk. Only tiles with candidates are computed,
    and no list is read past its count (the mesh plan kernel writes
    nothing there)."""
    n_tiles = tile_counts.shape[0]
    n = o.shape[0]
    rays = n // n_tiles
    dev = o.device
    best_t = torch.full((n_tiles, rays), BIG, device=dev)
    best_i = torch.full((n_tiles, rays), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n_tiles, rays), device=dev)
    best_v = torch.zeros((n_tiles, rays), device=dev)
    busy = torch.nonzero(tile_counts > 0).squeeze(1)
    if busy.numel():
        counts = tile_counts[busy]
        lists = tile_lists[busy].long()
        o4 = o.view(n_tiles, rays, 1, 3)[busy]
        d4 = d.view(n_tiles, rays, 1, 3)[busy]
        bt, bi = best_t[busy], best_i[busy]
        bu, bv = best_u[busy], best_v[busy]
        for s in range(0, int(counts.max()), chunk):
            live = (torch.arange(s, min(s + chunk, lists.shape[1]),
                                 device=dev)[None] < counts[:, None])
            ids = torch.where(live, lists[:, s:s + chunk], 0)  # (B, C)
            t, u, v, hit = _moller_trumbore(o4, d4, tri_scalars[ids][:, None])
            t = torch.where(hit & live[:, None], t, BIG)      # (B, R, C)
            arg = torch.argmin(t, dim=-1, keepdim=True)
            tmin = t.gather(-1, arg)[..., 0]
            better = tmin < bt
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, ids.gather(1, arg[..., 0]).int(), bi)
            bu = torch.where(better, u.gather(-1, arg)[..., 0], bu)
            bv = torch.where(better, v.gather(-1, arg)[..., 0], bv)
        best_t[busy], best_i[busy], best_u[busy], best_v[busy] = bt, bi, bu, bv
    return (best_t.reshape(n), best_i.reshape(n), best_u.reshape(n),
            best_v.reshape(n))


def raycast_reference(tri_scalars, o, d, ray_chunk: int = 1 << 16,
                      tri_chunk: int = 256):
    """Plain PyTorch version of the untiled kernel: every ray against
    every triangle, in blocks of ray_chunk rays x tri_chunk triangles; the
    first minimum in id order wins, as in the kernel's strict `<` walk."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), BIG, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    for r in range(0, n, ray_chunk):
        rs = slice(r, r + ray_chunk)
        bt, bi, bu, bv = best_t[rs], best_i[rs], best_u[rs], best_v[rs]
        for s in range(0, tri_scalars.shape[0], tri_chunk):
            t, u, v, hit = _moller_trumbore(o[rs, None], d[rs, None],
                                            tri_scalars[None, s:s + tri_chunk])
            t = torch.where(hit, t, BIG)                      # (R, C)
            arg = torch.argmin(t, dim=-1, keepdim=True)
            tmin = t.gather(-1, arg)[:, 0]
            better = tmin < bt
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, (arg[:, 0] + s).int(), bi)
            bu = torch.where(better, u.gather(-1, arg)[:, 0], bu)
            bv = torch.where(better, v.gather(-1, arg)[:, 0], bv)
        best_t[rs], best_i[rs], best_u[rs], best_v[rs] = bt, bi, bu, bv
    return best_t, best_i, best_u, best_v


def _check(name, x, dtype, ndim, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def raycast_tiled(tri_scalars, o, d, tile_lists, tile_counts):
    """Nearest back-face-culled hit of each ray among its tile's candidate
    triangles.

    tri_scalars (T, 9) f32 [v0|e1|e2] world space; o, d (N, 3) f32 with N
    a multiple of n_tiles, rays grouped tile-major; tile_lists
    (n_tiles, L) i32 front-packed ascending candidate ids; tile_counts
    (n_tiles,) i32 -> (t f32, idx i32, u f32, v f32), each (N,)."""
    global launches
    if o.device.type == "cpu":
        return raycast_tiled_reference(tri_scalars, o, d, tile_lists,
                                       tile_counts)
    if o.device.type != "cuda":
        raise ValueError(f"raycast_tiled: unsupported device {o.device}")
    dev = o.device
    _check("tri_scalars", tri_scalars, torch.float32, 2, dev)
    _check("o", o, torch.float32, 2, dev)
    _check("d", d, torch.float32, 2, dev)
    _check("tile_lists", tile_lists, torch.int32, 2, dev)
    _check("tile_counts", tile_counts, torch.int32, 1, dev)
    n, n_tiles = o.shape[0], tile_counts.shape[0]
    if (tri_scalars.shape[1] != 9 or o.shape[1] != 3 or d.shape != o.shape
            or tile_lists.shape[0] != n_tiles or n_tiles == 0
            or n % n_tiles or n_tiles > 65535):
        raise ValueError(
            f"raycast_tiled: bad shapes tri {tuple(tri_scalars.shape)}, "
            f"o {tuple(o.shape)}, d {tuple(d.shape)}, lists "
            f"{tuple(tile_lists.shape)}, counts {tuple(tile_counts.shape)}")
    lib = load_library()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    n_tris, list_len, tile_rays = (tri_scalars.shape[0], tile_lists.shape[1],
                                   n // n_tiles)
    # the packed triangles, the mesh extent, the work list and the
    # chunk-merge keys
    scratch = torch.empty(
        lib.nmr_raycast_tiled_scratch(n_tris, n_tiles, list_len, tile_rays),
        dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):     # the runtime launches on its device
        err = lib.nmr_raycast_tiled(
            tri_scalars.data_ptr(), n_tris, o.data_ptr(), d.data_ptr(),
            tile_lists.data_ptr(), tile_counts.data_ptr(), list_len,
            n_tiles, tile_rays, t.data_ptr(), idx.data_ptr(), u.data_ptr(),
            v.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh ray-cast kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return t, idx, u, v


def raycast(tri_scalars, o, d):
    """Nearest back-face-culled hit of each ray among all triangles.

    tri_scalars (T, 9) f32 [v0|e1|e2] world space; o, d (N, 3) f32, any N
    -> (t f32, idx i32, u f32, v f32), each (N,); a miss gives t = 1e16,
    idx -1."""
    global raycast_launches
    if o.device.type == "cpu":
        return raycast_reference(tri_scalars, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"raycast: unsupported device {o.device}")
    dev = o.device
    _check("tri_scalars", tri_scalars, torch.float32, 2, dev)
    _check("o", o, torch.float32, 2, dev)
    _check("d", d, torch.float32, 2, dev)
    if tri_scalars.shape[1] != 9 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"raycast: bad shapes tri {tuple(tri_scalars.shape)}, "
                         f"o {tuple(o.shape)}, d {tuple(d.shape)}")
    lib = load_library()
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, idx, u, v
    n_tris = tri_scalars.shape[0]
    # the packed triangles and the mesh extent
    scratch = torch.empty(lib.nmr_raycast_scratch(n_tris), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.nmr_raycast(
            tri_scalars.data_ptr(), o.data_ptr(), d.data_ptr(), n_tris, n,
            t.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh ray-cast kernel launch failed: "
                           f"cudaError_t {err}")
    raycast_launches += 1
    return t, idx, u, v

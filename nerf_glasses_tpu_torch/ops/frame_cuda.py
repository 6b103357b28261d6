"""The frame around the march: four CUDA kernels, their wrappers and their
plain PyTorch versions.

- `mesh_plan` (nmr_mesh_plan) puts the triangles in world space, bins
  them to 128x64 screen tiles and makes the mesh pass's tile-major rays:
  everything the tiled ray-cast (mesh_cuda.raycast_tiled) takes. Plain
  version `mesh_plan_reference` (world_triangles, _bin_triangles and the
  ray generation; JAX nerf_glasses_tpu/ops/triangles.py:603
  `_bin_triangles` and `render_mesh_pass_tiled` at :383).
- `surface_shade` (nmr_surface_shade) PBR-shades the ray-cast's hits and
  reduces each FxF block of supersampled rays to a NeRF pixel's surface
  colour and depth, row-major. Plain version `surface_shade_reference`
  (JAX triangles.py:254 `shade_hits`, :529 `render_mesh_surface`, :699
  `downsample_surface`).
- `ray_init` (nmr_ray_init) makes a plain perspective camera's rays (or
  takes the caller's) and the march's state: init_rays before and after
  its walk (which stays march_cuda.init_walk, run where it has probes),
  _make_state's fills, the flash floor and, on the list route, the first
  live-ray list. Plain
  version `ray_init_reference` (JAX raymarch.py:518 `init_rays`, :690
  `_make_state`, :1472 `render_image_device`).
- `finalize` (nmr_frame_finalize) is _finalize and _shade_frame in one
  pass: the (H, W, 4) frame and the (H, W) depth. Plain version
  `finalize_reference` (JAX raymarch.py:1096 `_finalize`, :1515
  `_shade_frame`).

None of them replaces a Pallas kernel: on the TPU, XLA fused this glue
into the frame's programs (csrc/frame.cu says what each kernel replaces
and why it is built as it is).

On a CUDA tensor a wrapper launches its kernel (csrc/frame.cu, built with
nvcc for sm_90a at first use, ops/cuda_build.py) or raises; on a CPU
tensor it runs its plain version. Each wrapper checks its inputs on every
device (ValueError) before it routes and counts its launches in
`launches[name]`. `plain_on_card[name]` counts the calls of a plain
version on a CUDA tensor (those that hold a kernel against it included):
no wrapper makes one, so on a frame's path it stays 0.

The contract (`compare_with_plain`): the mesh plan's counts equal and each
list equal over its count (the kernel writes no further), its triangles
and the rays of the tiles whose count is above 0 (the kernel writes no
other) within PLAN_RTOL x max(1, |x|); the surface colour within
SHADE_ATOL and its depth equal, on a textured mesh (`shade_error_scale`
given) within SHADE_ATOL + SHADE_COND x the pixel's own sensitivity to
float32 rounding (a sharp GGX lobe at a near-zero textured roughness, or
a normal map, turns an ulp of a normal into more than SHADE_ATOL of
sRGB, and the plain version itself is that far from its float64 value
there) but for at most max(4, ceil(1e-4 x covered pixels)) pixels (where
the light or the view grazes the surface the shading model's `dot > 0`
mask flips with an ulp and the colour jumps: either side is a rounding of
the same value); the ray init's flags equal, its list the alive set, its
floats within INIT_RTOL x max(1, |x|), but where the init walk runs, for
at most max(4, ceil(1e-4 n)) rays a t and t_start a walk's step apart
(an ulp of a direction can move a ray's walk a step: within
march_cuda.STEP_TOL); the finalized frame within FINALIZE_ATOL and its
depth equal. The kernels repeat the card's plain versions' float32
operations but for the order of a library's matrix products
(csrc/frame.cu).
"""

from __future__ import annotations

import copy
import ctypes
import math

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.ops import cuda_build
from nerf_glasses_tpu_torch.ops import march_cuda
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb, srgb_to_linear
from nerf_glasses_tpu_torch.ops.compaction import stable_partition_ids
from nerf_glasses_tpu_torch.ops.hashgrid import U32, mul_u32
from nerf_glasses_tpu_torch.ops.march_cuda import _arg
from nerf_glasses_tpu_torch.utils.bbox import contains_aabb, ray_intersect_aabb

_SOURCE = f"{cuda_build.PKG}/csrc/frame.cu"
# -fmad=false: the kernels round every product and sum on its own, as
# aten's elementwise ops do.
NVCC_FLAGS = cuda_build.ARCH_FLAGS + ("-fmad=false",)

TILE_W, TILE_H = 128, 64      # screen tile = one ray block of the ray-cast
TEX_SLOTS = ("base_color_texture", "metallic_roughness_texture",
             "emissive_texture", "normal_texture", "occlusion_texture")
MAX_INSTANCES = 16            # instance transforms passed by value
MAT_STRIDE = 12               # floats a material in the packed table
STAGE_RAYS, STAGE_STATE, STAGE_GIVEN = 1, 2, 4

# The kernel-vs-plain contract (compare_with_plain).
PLAN_RTOL = 1e-6
SHADE_ATOL = 1e-5
SHADE_COND = 4.0
INIT_RTOL = 1e-6
FINALIZE_ATOL = 1e-6
MISMATCH_FRACTION = 1e-4
MISMATCH_MIN = 4

KERNELS = ("mesh_plan", "surface_shade", "ray_init", "finalize")
# Kernel launches per wrapper (CUDA tensors only), and plain-version calls
# on a CUDA tensor.
launches = dict.fromkeys(KERNELS, 0)
plain_on_card = dict.fromkeys(KERNELS, 0)

_lib = None
build_log = ""
build_seconds = 0.0


class PlanParams(ctypes.Structure):
    """csrc/frame.cu's PlanParams."""
    _fields_ = [("cam", ctypes.c_float * 12), ("cam_inv", ctypes.c_float * 9),
                ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
                ("width_f", ctypes.c_float), ("height_f", ctypes.c_float),
                ("wp_f", ctypes.c_float), ("hp_f", ctypes.c_float),
                ("n_tris", ctypes.c_int), ("n_inst", ctypes.c_int),
                ("ntx", ctypes.c_int), ("nty", ctypes.c_int),
                ("n_tiles", ctypes.c_int),
                ("xf", ctypes.c_float * (MAX_INSTANCES * 12))]


class PlanArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("v0", "e1", "e2", "inst", "xf", "tri", "o", "d", "lists",
                 "counts")]


class ShadeParams(ctypes.Structure):
    """csrc/frame.cu's ShadeParams."""
    _fields_ = [("eye", ctypes.c_float * 3), ("light", ctypes.c_float * 3),
                ("inv_ff", ctypes.c_float), ("out_w", ctypes.c_int),
                ("out_h", ctypes.c_int), ("factor", ctypes.c_int),
                ("ntx", ctypes.c_int), ("n_inst", ctypes.c_int),
                ("n_mat", ctypes.c_int), ("n_tiles", ctypes.c_int),
                ("nrm", ctypes.c_float * (MAX_INSTANCES * 9))]


class ShadeArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("t", "u", "v", "tri", "counts", "d", "n", "tan", "uv",
                 "mat_id", "inst_id", "nrm", "mat", "tex", "texels", "rgba",
                 "depth")]


class InitParams(ctypes.Structure):
    """csrc/frame.cu's InitParams."""
    _fields_ = [("cam", ctypes.c_float * 12), ("eye", ctypes.c_float * 3),
                ("ox", ctypes.c_float), ("oy", ctypes.c_float),
                ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
                ("cone", ctypes.c_float), ("dt_min", ctypes.c_float),
                ("dt_max", ctypes.c_float), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("stage", ctypes.c_int),
                ("jitter", ctypes.c_int), ("max_cascade", ctypes.c_int),
                ("lowres_f", ctypes.c_int), ("coarse_w", ctypes.c_int),
                ("make_list", ctypes.c_int), ("seed", ctypes.c_uint)]


_INIT_ARGS = ("box_lo", "box_hi", "surf_in", "t_surf_in", "t_floor",
              "alive_img", "t_walk", "alive_walk", "o", "d", "surf", "t_surf",
              "t_pre", "alive_pre", "t", "t_start", "rgba", "depth",
              "max_weight", "wn", "surf_a", "alive", "ids", "n_ids")


class InitArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _INIT_ARGS]


class FinalizeParams(ctypes.Structure):
    """csrc/frame.cu's FinalizeParams: the plain version's Python numbers
    as float32, the divisions as the card's products with reciprocals."""
    _fields_ = [("n", ctypes.c_int), ("linear", ctypes.c_int),
                ("keep_a", ctypes.c_float), ("depth_a", ctypes.c_float),
                ("lin_cut", ctypes.c_float), ("inv_1292", ctypes.c_float),
                ("add", ctypes.c_float), ("inv_1055", ctypes.c_float),
                ("gamma", ctypes.c_float)]


class FinalizeArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("rgba_in", "depth_in", "rgba", "depth")]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    lib, build_log, build_seconds = cuda_build.build_library(_SOURCE,
                                                             NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.declare(lib, [
        ("nmr_frame_max_instances", [], i),
        ("nmr_mesh_plan", [p, p, p], i),
        ("nmr_surface_shade", [p, p, p], i),
        ("nmr_ray_init", [p, p, p], i),
        ("nmr_frame_finalize", [p, p, p], i)])
    if lib.nmr_frame_max_instances() != MAX_INSTANCES:
        raise RuntimeError("csrc/frame.cu and ops/frame_cuda.py disagree on "
                           "MAX_INSTANCES")
    _lib = lib
    return _lib


def _launch(name, fn, dev, *args):
    """One entry-point call on dev's current stream, under dev."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frame kernel {name} launch failed: "
                           f"cudaError_t {err}")
    launches[name] += 1


def _route(name, x):
    """-> True where `name` launches its kernel (a CUDA tensor), False for
    its plain version (a CPU tensor); ValueError for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _pixels(name, x, shape, device):
    """A per-pixel float32 tensor of any shape with shape's size, as
    `shape` (contiguous), or ValueError."""
    if not torch.is_tensor(x) or x.numel() != math.prod(shape):
        raise ValueError(f"{name} must be a tensor of {math.prod(shape)} "
                         f"elements, got {getattr(x, 'shape', x)}")
    return _arg(name, x.reshape(shape), torch.float32, shape, device)


def _host(name, x, shape):
    """A host array (numpy or a tensor) as float32 numpy of `shape` (None:
    any size there), or ValueError."""
    a = np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, np.float32)
    if a.ndim != len(shape) or any(s is not None and s != z
                                   for s, z in zip(shape, a.shape)):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{a.shape}")
    return a


def _ptr(x):
    return None if x is None else x.data_ptr()


def _plain(name, x):
    """Note a plain version of `name` run on x's device."""
    if x.device.type == "cuda":
        plain_on_card[name] += 1


def textured(mesh) -> bool:
    """Whether any material of the mesh samples a texture."""
    return bool((mesh.tex_table[..., 1] > 0).any())


def _tile_grid(width: int, height: int):
    """-> (wp, hp, ntx, nty): the tile-padded size and the tile grid."""
    if width <= 0 or height <= 0:
        raise ValueError(f"bad frame size {width}x{height}")
    wp = -(-width // TILE_W) * TILE_W
    hp = -(-height // TILE_H) * TILE_H
    return wp, hp, wp // TILE_W, hp // TILE_H


# ---------------------------------------------------------------------------
# Materials, packed once per load_mesh
# ---------------------------------------------------------------------------

def pack_materials(materials, device):
    """The materials' factors as one (M, MAT_STRIDE) float32 table (base
    colour 4, metallic, roughness, emissive 3, normal scale, occlusion
    strength), their textures as one float32 texel buffer and an (M, 5, 4)
    int32 table (offset in floats, height, width, channels; height 0 where
    a slot has no texture) -> (table, slots, texels, textures): textures,
    per material {slot: (h, w, c) tensor}, are views of the texel buffer."""
    m = len(materials)
    table = np.zeros((m, MAT_STRIDE), np.float32)
    slots = np.zeros((m, len(TEX_SLOTS), 4), np.int32)
    parts, shapes, off = [], {}, 0
    for k, mat in enumerate(materials):
        table[k, 0:4] = mat.base_color_factor
        table[k, 4] = mat.metallic_factor
        table[k, 5] = mat.roughness_factor
        table[k, 6:9] = mat.emissive_factor
        table[k, 9] = mat.normal_scale
        table[k, 10] = mat.occlusion_strength
        for s, name in enumerate(TEX_SLOTS):
            tex = getattr(mat, name)
            if tex is None:
                continue
            tex = np.asarray(tex, np.float32)
            shapes[k, s] = tex.shape
            h, w = tex.shape[:2]
            slots[k, s] = (off, h, w, tex.size // (h * w))
            parts.append(tex.reshape(-1))
            off += tex.size
    texels = torch.as_tensor(np.concatenate(parts) if parts
                             else np.zeros(1, np.float32), device=device)
    textures = [{} for _ in range(m)]
    for (k, s), shape in shapes.items():
        at = int(slots[k, s, 0])
        textures[k][TEX_SLOTS[s]] = texels[at:at + int(np.prod(shape))].view(
            shape)

    return (torch.as_tensor(table, device=device),
            torch.as_tensor(slots, device=device), texels, textures)


# ---------------------------------------------------------------------------
# nmr_mesh_plan: world triangles, binning and the mesh pass's rays
# ---------------------------------------------------------------------------

def world_triangles(mesh, xforms: torch.Tensor):
    """The object-space soup through each triangle's instance transform
    (xforms (I, 3, 4) on the mesh's device) -> world (v0, e1, e2), (T, 3)
    each."""
    rot = xforms[mesh.inst_id, :, :3]
    return (torch.einsum("tij,tj->ti", rot, mesh.v0)
            + xforms[mesh.inst_id, :, 3],
            torch.einsum("tij,tj->ti", rot, mesh.e1),
            torch.einsum("tij,tj->ti", rot, mesh.e2))


def bin_triangles(v0, e1, e2, eye, cam3_inv, width: int, height: int,
                  wp: int, hp: int):
    """Conservative screen-space bbox binning -> (tile_lists (n_tiles, T)
    i32 front-packed ascending ids, counts (n_tiles,) i32). Triangles with
    any vertex at or behind the eye plane go to every tile. Projection
    uses the logical width/height, not the tile padding."""
    verts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)     # (T, 3, 3)
    ndc = torch.einsum("ij,tvj->tvi", cam3_inv, verts - eye)
    z = ndc[..., 2]
    behind = torch.any(z <= 1e-6, dim=1)
    zs = torch.where(z <= 1e-6, 1.0, z)
    px = (ndc[..., 0] / zs * 0.5 + 0.5) * width
    py = (ndc[..., 1] / zs * 0.5 + 0.5) * height
    pad = 1.0
    xmin = torch.where(behind, 0.0, px.amin(1) - pad)
    xmax = torch.where(behind, float(wp), px.amax(1) + pad)
    ymin = torch.where(behind, 0.0, py.amin(1) - pad)
    ymax = torch.where(behind, float(hp), py.amax(1) + pad)

    ntx, nty = wp // TILE_W, hp // TILE_H
    tx0 = (torch.arange(ntx, device=v0.device) * TILE_W).float()
    ty0 = (torch.arange(nty, device=v0.device) * TILE_H).float()
    ox = (xmax[None] >= tx0[:, None]) & (xmin[None] <= tx0[:, None] + TILE_W)
    oy = (ymax[None] >= ty0[:, None]) & (ymin[None] <= ty0[:, None] + TILE_H)
    overlap = (oy[:, None, :] & ox[None, :, :]).reshape(ntx * nty, -1)
    counts = overlap.sum(dim=1).int()
    # front-pack overlapping ids; a stable sort keeps them ascending
    order = torch.argsort((~overlap).to(torch.uint8), dim=1, stable=True)
    return order.int().contiguous(), counts


def mesh_plan_reference(mesh, xforms, camera, width: int, height: int):
    """Plain version of nmr_mesh_plan (tiled_raycast_inputs' aten code):
    each list's ids past its count are the other ids, ascending."""
    dev = mesh.v0.device
    _plain("mesh_plan", mesh.v0)
    f32 = dict(dtype=torch.float32, device=dev)
    wp, hp, ntx, nty = _tile_grid(width, height)
    cam = torch.as_tensor(np.asarray(camera), **f32)
    xforms = torch.as_tensor(np.asarray(xforms), **f32)
    eye = cam[:, 3]
    cam3 = cam[:, :3]

    px = torch.arange(wp, **f32) + 0.5
    py = torch.arange(hp, **f32) + 0.5
    ndc = torch.stack([(px / width * 2.0 - 1.0)[None].expand(hp, wp),
                       (py / height * 2.0 - 1.0)[:, None].expand(hp, wp),
                       torch.ones((hp, wp), **f32)], dim=-1)
    d = ndc @ cam3.T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d_t = (d.reshape(nty, TILE_H, ntx, TILE_W, 3).permute(0, 2, 1, 3, 4)
           .reshape(-1, 3).contiguous())

    v0, e1, e2 = world_triangles(mesh, xforms)
    lists, counts = bin_triangles(v0, e1, e2, eye, torch.linalg.inv(cam3),
                                  width, height, wp, hp)
    return {"tri_scalars": torch.cat([v0, e1, e2], dim=1).contiguous(),
            "o": eye.expand(d_t.shape).contiguous(), "d": d_t,
            "tile_lists": lists, "tile_counts": counts, "ntx": ntx,
            "nty": nty}


def _check_mesh(name, mesh, dev):
    t = mesh.v0.shape[0]
    for k, dtype, shape in (("v0", torch.float32, (t, 3)),
                            ("e1", torch.float32, (t, 3)),
                            ("e2", torch.float32, (t, 3)),
                            ("inst_id", torch.int64, (t,))):
        _arg(f"{name}: mesh.{k}", getattr(mesh, k), dtype, shape, dev)


def mesh_plan(mesh, xforms, camera, width: int, height: int):
    """Everything the tiled ray-cast takes for a (width, height) pass of
    the mesh (MeshArrays on the card or the CPU) through `camera` (3, 4)
    with instance transforms `xforms` (I, 3, 4) (host arrays) -> dict:
    tri_scalars (T, 9) f32 world [v0 | e1 | e2]; o, d (n_tiles * 8192, 3)
    f32 tile-major rays through the pixel centres; tile_lists (n_tiles, T)
    i32, each front-packed with its candidates ascending (the kernel
    writes nothing past them); tile_counts (n_tiles,) i32; the tile grid
    ntx, nty. On a CUDA tensor one launch of nmr_mesh_plan, a block a
    tile, which writes the rays of the tiles whose count is above 0 only:
    the rays of a tile with no candidate are undefined, and nothing reads
    them (the tiled ray-cast gives such a tile's misses without its rays,
    the surface shade reads a ray only for a hit). The plain version
    writes every ray."""
    dev = mesh.v0.device
    kernel = _route("mesh_plan", mesh.v0)
    _check_mesh("mesh_plan", mesh, dev)
    cam = _host("mesh_plan: camera", camera, (3, 4))
    xf = _host("mesh_plan: xforms", xforms, (None, 3, 4))
    n_tris = mesh.v0.shape[0]
    if n_tris == 0 or xf.shape[0] == 0:
        raise ValueError("mesh_plan: no triangles or no instances")
    wp, hp, ntx, nty = _tile_grid(width, height)
    if not kernel:
        return mesh_plan_reference(mesh, xf, cam, width, height)
    lib = load_library()
    n_tiles = ntx * nty
    n_rays = n_tiles * TILE_W * TILE_H
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"tri_scalars": torch.empty((n_tris, 9), **f32),
           "o": torch.empty((n_rays, 3), **f32),
           "d": torch.empty((n_rays, 3), **f32),
           "tile_lists": torch.empty((n_tiles, n_tris), dtype=torch.int32,
                                     device=dev),
           "tile_counts": torch.empty(n_tiles, dtype=torch.int32, device=dev),
           "ntx": ntx, "nty": nty}
    f = np.float32
    params = PlanParams(
        inv_w=f(1) / f(width), inv_h=f(1) / f(height), width_f=width,
        height_f=height, wp_f=wp, hp_f=hp, n_tris=n_tris, n_inst=xf.shape[0],
        ntx=ntx, nty=nty, n_tiles=n_tiles)
    params.cam[:] = cam.reshape(-1).tolist()
    params.cam_inv[:] = np.linalg.inv(cam[:, :3].astype(np.float64)).astype(
        np.float32).reshape(-1).tolist()
    xf_dev = None
    if xf.shape[0] <= MAX_INSTANCES:
        params.xf[:xf.size] = xf.reshape(-1).tolist()
    else:
        xf_dev = torch.as_tensor(xf, **f32)
    args = PlanArgs(v0=mesh.v0.data_ptr(), e1=mesh.e1.data_ptr(),
                    e2=mesh.e2.data_ptr(), inst=mesh.inst_id.data_ptr(),
                    xf=_ptr(xf_dev), tri=out["tri_scalars"].data_ptr(),
                    o=out["o"].data_ptr(), d=out["d"].data_ptr(),
                    lists=out["tile_lists"].data_ptr(),
                    counts=out["tile_counts"].data_ptr())
    _launch("mesh_plan", lib.nmr_mesh_plan, dev, ctypes.byref(params),
            ctypes.byref(args))
    return out


# ---------------------------------------------------------------------------
# nmr_surface_shade: PBR shading fused with the FxF reduce
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def sample_texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, repeat wrap, normalized coords (CudaTexture semantics)."""
    h, w = tex.shape[:2]
    u = (uv[:, 0] % 1.0) * w - 0.5
    v = (uv[:, 1] % 1.0) * h - 0.5
    x0 = torch.floor(u).long()
    y0 = torch.floor(v).long()
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]

    def at(x, y):
        return tex[y % h, x % w]

    return (at(x0, y0) * (1 - fx) * (1 - fy)
            + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy
            + at(x0 + 1, y0 + 1) * fx * fy)


def _d_ggx(dot_nh, alpha):
    a2 = alpha * alpha
    f = (dot_nh * a2 - dot_nh) * dot_nh + 1.0
    return a2 / (f * f)


def _g_ggx(dot_nl, dot_nv, alpha):
    a2 = alpha * alpha
    lv = torch.clamp(dot_nl, min=0.0) / torch.sqrt(a2 + (1 - a2) * dot_nv * dot_nv)
    ll = torch.clamp(dot_nv, min=0.0) / torch.sqrt(a2 + (1 - a2) * dot_nl * dot_nl)
    return 0.5 / (lv + ll + 1e-4)


def _f_schlick(f0, u):
    return f0 + (1.0 - f0) * torch.pow(1.0 - u, 5.0)


def shade_hits(mesh, o, d, t, tri, uv_bary, nrm_mats, light_pos, cam_eye):
    """PBR metallic-roughness shading of hit points -> linear rgb (N, 3);
    zeros where tri < 0. nrm_mats (I, 3, 3) instance normal matrices."""
    hit = tri >= 0
    tri_c = torch.clamp(tri, min=0).long()
    u = uv_bary[:, 0:1]
    v = uv_bary[:, 1:2]
    w0 = 1.0 - u - v

    nm = nrm_mats[mesh.inst_id[tri_c]]                     # (N, 3, 3)
    n_vert = mesh.n[tri_c]
    n_obj = w0 * n_vert[:, 0] + u * n_vert[:, 1] + v * n_vert[:, 2]
    n_geo = torch.einsum("nij,nj->ni", nm, n_obj)
    t_vert = mesh.tan[tri_c]
    tan4 = w0 * t_vert[:, 0] + u * t_vert[:, 1] + v * t_vert[:, 2]
    tan_w = torch.einsum("nij,nj->ni", nm, tan4[:, :3])
    uv_vert = mesh.uv[tri_c]
    uv = w0 * uv_vert[:, 0] + u * uv_vert[:, 1] + v * uv_vert[:, 2]

    mid = mesh.mat_id[tri_c]
    base = mesh.base_color[mid]
    metallic = mesh.metallic[mid]
    roughness = mesh.roughness[mid]
    emissive = mesh.emissive[mid]
    occlusion = torch.ones_like(metallic)

    # TBN (Gram-Schmidt, optix_scene.cu:92-98)
    nrm = _normalize(n_geo)
    tng = _normalize(tan_w - nrm * torch.sum(tan_w * nrm, -1, keepdim=True))
    btn = torch.cross(nrm, tng, dim=-1) * tan4[:, 3:4]

    normal = nrm
    for i, tex in enumerate(mesh.textures):
        mmask = (mid == i)[:, None]
        if "base_color_texture" in tex:
            texv = sample_texture(tex["base_color_texture"], uv)
            base = torch.where(mmask, base * texv, base)
        if "metallic_roughness_texture" in tex:
            mr = sample_texture(tex["metallic_roughness_texture"], uv)
            metallic = torch.where(mmask[:, 0], metallic * mr[:, 2], metallic)
            roughness = torch.where(mmask[:, 0], roughness * mr[:, 1],
                                    roughness)
        if "emissive_texture" in tex:
            ev = sample_texture(tex["emissive_texture"], uv)
            emissive = torch.where(mmask, emissive * ev[:, :3], emissive)
        if "normal_texture" in tex:
            nt = sample_texture(tex["normal_texture"], uv)
            ns = mesh.normal_scale[mid]
            ntan = (nt[:, :3] * 2.0 - 1.0) * torch.stack(
                [ns, ns, torch.ones_like(metallic)], -1)
            mapped = (tng * ntan[:, 0:1] + btn * ntan[:, 1:2]
                      + nrm * ntan[:, 2:3])
            normal = torch.where(mmask, mapped, normal)
        if "occlusion_texture" in tex:
            ot = sample_texture(tex["occlusion_texture"], uv)
            occ_v = 1.0 + mesh.occlusion_strength[mid] * (ot[:, 0] - 1.0)
            occlusion = torch.where(mmask[:, 0], occ_v, occlusion)

    N = _normalize(normal)
    hit_pos = o + t[:, None] * d
    ambient = base[:, :3] * 0.2 * occlusion[:, None]
    V = _normalize(cam_eye - hit_pos)
    L = _normalize(light_pos - hit_pos)
    H = _normalize(V + L)

    dot_nl = torch.sum(N * L, -1)
    dot_nv = torch.sum(N * V, -1)
    fd = ((1.0 - metallic[:, None]) * base[:, :3]
          * torch.clamp(dot_nl, min=0.0)[:, None])
    dot_nh = torch.clamp(torch.sum(N * H, -1), 0.0, 1.0)
    dot_lh = torch.clamp(torch.sum(L * H, -1), 0.0, 1.0)
    alpha = roughness * roughness
    f0 = ((0.5 * alpha)[:, None] * (1.0 - metallic[:, None])
          + base[:, :3] * metallic[:, None])
    D = _d_ggx(dot_nh, alpha)
    G = _g_ggx(dot_nl, dot_nv, alpha)
    F = _f_schlick(f0, dot_lh[:, None])
    fr = torch.abs(D[:, None] * G[:, None] * F / math.pi)
    fr = torch.where(((dot_nv > 0) & (dot_nl > 0))[:, None], fr, 0.0)
    rgb = ambient + fd + fr + emissive
    return torch.where(hit[:, None], rgb, 0.0)


def surface_shade_reference(mesh, plan, hits, nrm_mats, light_pos, camera,
                            width: int, height: int, factor: int,
                            dtype=torch.float32):
    """Plain version of nmr_surface_shade (render_mesh_pass_tiled's aten
    code after the ray-cast); dtype: the precision it computes in."""
    dev = mesh.v0.device
    _plain("surface_shade", mesh.v0)
    f32 = dict(dtype=dtype, device=dev)
    nrm_mats = torch.as_tensor(np.asarray(nrm_mats), **f32)
    light = torch.as_tensor(np.asarray(light_pos, np.float32), **f32)
    eye = torch.as_tensor(np.asarray(camera), **f32)[:, 3]
    d_t, ntx, nty = plan["d"], plan["ntx"], plan["nty"]
    t, tri, uu, vv = hits

    # Shade whole tiles that hold any hit (misses masked) and reduce each
    # FxF block inside the tile; tiles are unique, so plain assignment
    # stores the result.
    pix = TILE_H * TILE_W
    n_tiles = nty * ntx
    th, tw = TILE_H // factor, TILE_W // factor
    tri4 = tri.view(n_tiles, pix)
    perm, n_hit = stable_partition_ids(torch.any(tri4 >= 0, dim=1))
    color = torch.zeros((n_tiles, th, tw, 4), **f32)
    depth = torch.zeros((n_tiles, th, tw), **f32)
    if n_hit:
        tidx = perm[:n_hit]
        k = tidx.numel()
        tt = t.view(n_tiles, pix)[tidx].reshape(-1)
        trit = tri4[tidx].reshape(-1)
        valid = trit >= 0
        uv_c = torch.stack([uu.view(n_tiles, pix)[tidx].reshape(-1),
                            vv.view(n_tiles, pix)[tidx].reshape(-1)], dim=-1)
        d_c = d_t.view(n_tiles, pix, 3)[tidx].reshape(-1, 3)
        rgb = shade_hits(mesh, eye.expand(d_c.shape), d_c, tt, trit, uv_c,
                         nrm_mats, light, eye)
        srgb = linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
        contrib = torch.where(
            valid[:, None],
            torch.cat([srgb, torch.ones_like(srgb[:, :1])], dim=-1)
            * (1.0 / float(factor * factor)), 0.0)
        color[tidx] = (contrib.view(k, th, factor, tw, factor, 4)
                       .sum(dim=(2, 4)))
        depth[tidx] = (torch.where(valid, tt, 0.0)
                       .view(k, th, factor, tw, factor).amax(dim=(2, 4)))
    color = (color.view(nty, ntx, th, tw, 4).permute(0, 2, 1, 3, 4)
             .reshape(nty * th, ntx * tw, 4))
    depth = (depth.view(nty, ntx, th, tw).permute(0, 2, 1, 3)
             .reshape(nty * th, ntx * tw))
    return (color[:height // factor, :width // factor],
            depth[:height // factor, :width // factor])


def shade_error_scale(mesh, plan, hits, nrm_mats, light_pos, camera,
                      width: int, height: int, factor: int):
    """How far float32 rounding alone moves each output pixel's colour
    (compare_with_plain's conditioning), (height/F, width/F, 4): the
    largest change of the plain version when it is evaluated in float64
    on the same inputs, or with every vertex normal and tangent moved one
    float32 step up, or one down."""
    f64 = copy.copy(mesh)
    for k in ("n", "tan", "uv", "base_color", "metallic", "roughness",
              "emissive", "normal_scale", "occlusion_strength"):
        setattr(f64, k, getattr(mesh, k).double())
    f64.textures = [{k: x.double() for k, x in tex.items()}
                    for tex in mesh.textures]
    t, tri, u, v = hits
    plan64 = {**plan, "d": plan["d"].double()}
    want = surface_shade_reference(f64, plan64, (t.double(), tri, u.double(),
                                                 v.double()),
                                   np.asarray(nrm_mats, np.float64),
                                   np.asarray(light_pos, np.float64),
                                   np.asarray(camera, np.float64), width,
                                   height, factor, torch.float64)[0]
    got = surface_shade_reference(mesh, plan, hits, nrm_mats, light_pos,
                                  camera, width, height, factor)[0]
    scale = (got.double() - want).abs().float()
    for to in (math.inf, -math.inf):
        nudged = copy.copy(mesh)
        nudged.n = torch.nextafter(mesh.n, torch.full_like(mesh.n, to))
        nudged.tan = torch.nextafter(mesh.tan, torch.full_like(mesh.tan, to))
        alt = surface_shade_reference(nudged, plan, hits, nrm_mats, light_pos,
                                      camera, width, height, factor)[0]
        scale = torch.maximum(scale, (alt - got).abs())
    return scale


def surface_shade(mesh, plan, hits, nrm_mats, light_pos, camera, width: int,
                  height: int, factor: int):
    """The mesh pass's hits shaded and FxF-reduced into per-pixel payloads
    -> (colour (height/F, width/F, 4) sRGB + coverage, the block mean;
    depth (height/F, width/F), the max hit distance, 0 where nothing was
    hit). plan: mesh_plan's dict for this (width, height); hits: the tiled
    ray-cast's (t, id, u, v) on its rays; nrm_mats (I, 3, 3), light_pos
    (3,) and camera (3, 4) host arrays; factor divides the 128x64 tile.
    On a CUDA tensor one launch of nmr_surface_shade: the busy tiles (a
    count above 0) a thread a supersampled ray, a pixel's rays summed in
    a thread-per-pixel loop's order; the other pixels zeros."""
    dev = mesh.v0.device
    kernel = _route("surface_shade", mesh.v0)
    if factor <= 0 or TILE_W % factor or TILE_H % factor:
        raise ValueError(f"factor {factor} must divide the {TILE_W}x{TILE_H} "
                         "tile")
    wp, hp, ntx, nty = _tile_grid(width, height)
    n_tiles = ntx * nty
    n_rays = n_tiles * TILE_W * TILE_H
    if (width // factor) * (height // factor) >= 2 ** 31:
        raise ValueError(f"surface_shade: {width}x{height} / {factor} is "
                         "2^31 pixels or more")
    t, tri, u, v = (_arg(f"surface_shade: hits[{k}]", x, dt, (n_rays,), dev)
                    for k, (x, dt) in enumerate(zip(hits, (
                        torch.float32, torch.int32, torch.float32,
                        torch.float32))))
    d = _arg("surface_shade: plan['d']", plan["d"], torch.float32,
             (n_rays, 3), dev)
    counts = _arg("surface_shade: plan['tile_counts']", plan["tile_counts"],
                  torch.int32, (n_tiles,), dev)
    nrm = _host("surface_shade: nrm_mats", nrm_mats, (None, 3, 3))
    light = _host("surface_shade: light_pos", light_pos, (3,))
    cam = _host("surface_shade: camera", camera, (3, 4))
    if not kernel:
        return surface_shade_reference(mesh, plan, (t, tri, u, v), nrm, light,
                                       cam, width, height, factor)
    n_t = mesh.v0.shape[0]
    m = mesh.mat_table.shape[0]
    attrs = [_arg(f"surface_shade: mesh.{k}", getattr(mesh, k), dt, shape, dev)
             for k, dt, shape in (
                 ("n", torch.float32, (n_t, 3, 3)),
                 ("tan", torch.float32, (n_t, 3, 4)),
                 ("uv", torch.float32, (n_t, 3, 2)),
                 ("mat_id", torch.int64, (n_t,)),
                 ("inst_id", torch.int64, (n_t,)),
                 ("mat_table", torch.float32, (m, MAT_STRIDE)),
                 ("tex_table", torch.int32, (m, len(TEX_SLOTS), 4)),
                 ("texels", torch.float32, tuple(mesh.texels.shape)))]
    lib = load_library()
    out_w, out_h = width // factor, height // factor
    f32 = dict(dtype=torch.float32, device=dev)
    rgba = torch.empty((out_h, out_w, 4), **f32)
    depth = torch.empty((out_h, out_w), **f32)
    params = ShadeParams(inv_ff=np.float32(1.0 / float(factor * factor)),
                         out_w=out_w, out_h=out_h, factor=factor, ntx=ntx,
                         n_inst=nrm.shape[0], n_mat=m, n_tiles=n_tiles)
    params.eye[:] = cam[:, 3].tolist()
    params.light[:] = light.tolist()
    nrm_dev = None
    if nrm.shape[0] <= MAX_INSTANCES:
        params.nrm[:nrm.size] = nrm.reshape(-1).tolist()
    else:
        nrm_dev = torch.as_tensor(nrm, **f32)
    args = ShadeArgs(t=t.data_ptr(), u=u.data_ptr(), v=v.data_ptr(),
                     tri=tri.data_ptr(), counts=counts.data_ptr(),
                     d=d.data_ptr(), n=attrs[0].data_ptr(),
                     tan=attrs[1].data_ptr(), uv=attrs[2].data_ptr(),
                     mat_id=attrs[3].data_ptr(), inst_id=attrs[4].data_ptr(),
                     nrm=_ptr(nrm_dev), mat=attrs[5].data_ptr(),
                     tex=attrs[6].data_ptr(), texels=attrs[7].data_ptr(),
                     rgba=rgba.data_ptr(), depth=depth.data_ptr())
    if out_w and out_h:
        _launch("surface_shade", lib.nmr_surface_shade, dev,
                ctypes.byref(params), ctypes.byref(args))
    return rgba, depth


# ---------------------------------------------------------------------------
# nmr_ray_init: a plain camera's rays, init_rays and the state's fills
# ---------------------------------------------------------------------------

def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer hash of uint32 values (held in int64) -> [0, 1) f32; the
    start-t jitter (stands in for random_val.cuh ld_random_val)."""
    x = x & U32
    x = mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x.float() * (1.0 / 4294967296.0)


def jitter_seed(sample_index) -> int:
    return ((int(sample_index) & U32) * 2654435761) & U32


def init_rays(scene, o, d, t_surface, opts, sample_index=0):
    """o, d (N, 3): origins in NGP space (+0.5 shifted) and unit dirs ->
    (t, t_start, alive)."""
    n = o.shape[0]
    tmin, _ = ray_intersect_aabb(o, d, scene["render_min"],
                                 scene["render_max"])
    t = torch.clamp(tmin, min=0.0) + 1e-6
    alive = contains_aabb(o + d * t[:, None], scene["render_min"],
                          scene["render_max"])
    has_surface = t_surface > 0.0
    t = torch.where(~alive & has_surface, t_surface, t)
    alive = alive | has_surface

    if opts.jitter:
        ray_idx = torch.arange(n, dtype=torch.int64, device=o.device)
        jit01 = hash_u32(mul_u32(ray_idx, 786433) + jitter_seed(sample_index))
        t = t + jit01 * occ_ops.calc_dt(t, opts.cone_angle)

    t, alive = march_cuda.init_walk(o, d, t, t_surface, alive, scene, opts)

    in_mip0 = occ_ops.mip_from_pos(o + d * t[:, None],
                                   opts.config.max_cascade) == 0
    t_start = torch.where(in_mip0, t, 0.0)
    return t, t_start, alive


def upsample_flash_init(tmin, alive_img, width: int, height: int, F: int):
    """(H/F, W/F) coarse init -> flattened full-resolution (t_floor,
    alive)."""
    def up(x):
        return (x.repeat_interleave(F, 0)[:height]
                .repeat_interleave(F, 1)[:, :width].reshape(-1))
    return up(tmin), up(alive_img)


def make_state(scene, o, d, surface_rgba, t_surface, opts, sample_index,
               t_floor=None, alive_mask=None):
    """The march's state of N rays (init_rays, then the flash floor where
    t_floor / alive_mask (N,) are given) -> dict."""
    _plain("ray_init", o)
    t0, t_start, alive0 = init_rays(scene, o, d, t_surface, opts,
                                    sample_index)
    n = o.shape[0]
    if t_floor is not None:
        # flash init: start at the coarse floor; rays the coarse pass found
        # empty survive only through their surface payload, and jump to it
        has_surface = t_surface > 0.0
        t0 = torch.maximum(t0, torch.where(
            alive_mask, t_floor, torch.where(has_surface, t_surface, t0)))
        alive0 = alive0 & (alive_mask | has_surface)
    return {
        # per-ray constants
        "o": o, "d": d, "surf": surface_rgba, "t_surf": t_surface,
        "t_start": t_start,
        # march state
        "t": t0,
        "rgba": torch.zeros((n, 4), device=o.device),
        "depth": torch.zeros((n,), device=o.device),
        "max_weight": torch.zeros((n,), device=o.device),
        "alive": alive0,
        "surf_a": torch.where(alive0, surface_rgba[:, 3], 0.0),
        # NeRF-only weight (no surface blend) for the deferred shade
        "wn": torch.zeros((n,), device=o.device),
    }


def camera_dirs(cam, width: int, height: int, offsets):
    """Plain version of the kernel's rays: a plain perspective packed
    camera's (N, 3) origins (+0.5 NGP shift) and unit dirs through the
    pixels at sub-pixel offsets (ox, oy), row-major."""
    f32 = dict(dtype=cam.dtype, device=cam.device)
    ox, oy = offsets
    u = ((torch.arange(width, **f32) + ox) / width)[None].expand(height, width)
    v = ((torch.arange(height, **f32) + oy) / height)[:, None].expand(height,
                                                                      width)
    x = u * 2.0 - 1.0
    y = v * 2.0 - 1.0
    dir_cam = torch.stack([x, y, torch.ones((height, width), **f32)],
                          dim=-1).reshape(-1, 3)
    d = dir_cam @ cam[:, :3].T
    o = (cam[:, 3] + 0.5).expand(d.shape)
    return o, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def ray_init_reference(scene, opts, camera, width: int, height: int,
                       offsets, sample_index=0, surface_rgba=None,
                       t_surface=None, coarse=None, make_list=False,
                       rays=None, coarse_factor=None):
    """Plain version of nmr_ray_init (render_image_device's ray generation,
    _make_state and _march_lists' first list)."""
    dev = scene["occ"].device
    f32 = dict(dtype=torch.float32, device=dev)
    npix = width * height
    if rays is None:
        cam = torch.as_tensor(np.asarray(camera, np.float32), **f32)
        o, d = camera_dirs(cam, width, height, offsets)
    else:
        o, d = rays
    if surface_rgba is None:
        surf = torch.zeros((npix, 4), **f32)
        tsurf = torch.zeros((npix,), **f32)
    else:
        surf = surface_rgba.reshape(npix, 4)
        tsurf = t_surface.reshape(npix)
    t_floor = alive_mask = None
    if coarse is not None:
        t_floor, alive_mask = upsample_flash_init(
            *coarse, width, height, coarse_factor or opts.lowres_factor)
    st = make_state(scene, o, d, surf, tsurf, opts, sample_index, t_floor,
                    alive_mask)
    first = None
    if make_list:
        ids = torch.nonzero(st["alive"]).squeeze(1).to(torch.int32)
        first = (ids, torch.tensor([ids.numel()], dtype=torch.int32,
                                   device=dev))
    return st, first


STATE_SHAPES = {"o": (3,), "d": (3,), "surf": (4,), "t_surf": (),
                "t_start": (), "t": (), "rgba": (4,), "depth": (),
                "max_weight": (), "alive": (), "surf_a": (), "wn": (),
                "ids": (), "n_ids": None}


def state_buffers(n: int, device) -> dict:
    """Buffers of a frame of n rays that ray_init can write (its `out`):
    the state's arrays, and the first list "ids" (n,) with its count
    "n_ids" (1,) int32."""
    out = {}
    for k, shape in STATE_SHAPES.items():
        dtype = (torch.bool if k == "alive" else torch.int32
                 if k in ("ids", "n_ids") else torch.float32)
        out[k] = torch.empty((1,) if shape is None else (n,) + shape,
                             dtype=dtype, device=device)
    return out


def _into(out, st, first, n):
    """The state and first list a plain version made, copied into out ->
    (out's state, out's first list or None)."""
    for k in st:
        _arg(f"ray_init: out[{k!r}]", out[k], st[k].dtype, st[k].shape,
             out[k].device).copy_(st[k])
    if first is None:
        return {k: out[k] for k in st}, None
    _arg("ray_init: out['ids']", out["ids"], torch.int32, (n,),
         out["ids"].device)[:first[0].numel()].copy_(first[0])
    out["n_ids"].copy_(first[1])
    return {k: out[k] for k in st}, (out["ids"], out["n_ids"])


def ray_init(scene, opts, camera, width: int, height: int, offsets,
             sample_index=0, surface_rgba=None, t_surface=None, coarse=None,
             make_list=False, rays=None, coarse_factor=None, out=None):
    """The march's state of a (width, height) frame -> (state, first):
    state as make_state's dict (o, d (N, 3); surf (N, 4); t_surf, t_start,
    t, depth, max_weight, surf_a, wn (N,) f32; rgba (N, 4); alive (N,)
    bool; N = width * height, row-major, contiguous); first, with
    make_list, (ids int32, count int32 (1,)): the alive rays' ids in
    ids[:count] (ascending in the plain version; in the kernel a block's
    rays together and ascending, the blocks in any order), else None.

    camera (3, 4) host array: a plain perspective camera, its rays through
    the pixels at sub-pixel offsets (ox, oy); or rays=(o, d) (N, 3), made
    by the caller (another camera model, a batch of rays as width N and
    height 1), and then camera is not read. opts: the frame's MarchOptions (the init
    walk runs where opts.init_skip_iters > 0). surface_rgba (H, W, 4) or
    (N, 4) and t_surface: the mesh pass's payloads, or None. coarse: the
    flash floor, (t_floor, alive) (H/F, W/F) grids as flash_init gives
    them, F = coarse_factor or opts.lowres_factor, or None. On a CUDA
    device one launch of nmr_ray_init, two around march_cuda.init_walk
    where it has probes. out: None, or state_buffers' dict of n rays to
    write the state and first list into (their addresses stay: the list
    route's cached march); the given rays and surface payloads are then
    copied into it (the rays by two copies, the payloads by the kernel)."""
    dev = scene["occ"].device
    kernel = _route("ray_init", scene["occ"])
    n = width * height
    if width <= 0 or height <= 0:
        raise ValueError(f"ray_init: bad frame size {width}x{height}")
    if (surface_rgba is None) != (t_surface is None):
        raise ValueError("ray_init: surface_rgba and t_surface go together")
    if surface_rgba is not None:
        surface_rgba = _pixels("ray_init: surface_rgba", surface_rgba, (n, 4),
                               dev)
        t_surface = _pixels("ray_init: t_surface", t_surface, (n,), dev)
    f = coarse_factor or opts.lowres_factor
    if coarse is not None:
        hl, wl = -(-height // f), -(-width // f)
        coarse = (_arg("ray_init: coarse t_floor", coarse[0], torch.float32,
                       (hl, wl), dev),
                  _arg("ray_init: coarse alive", coarse[1], torch.bool,
                       (hl, wl), dev))
    if rays is not None:
        rays = tuple(_arg(f"ray_init: rays[{k}]", x, torch.float32, (n, 3),
                          dev) for k, x in enumerate(rays))
    else:
        cam = _host("ray_init: camera", camera, (3, 4))
    if not kernel:
        st, first = ray_init_reference(scene, opts, camera, width, height,
                                       offsets, sample_index, surface_rgba,
                                       t_surface, coarse, make_list, rays,
                                       coarse_factor)
        return (st, first) if out is None else _into(out, st, first, n)
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    box = [_arg(f"ray_init: scene[{k!r}]", scene[k], torch.float32, (3,), dev)
           for k in ("render_min", "render_max")]
    if out is not None:
        st = {k: _arg(f"ray_init: out[{k!r}]", out[k],
                      torch.bool if k == "alive" else torch.float32,
                      (n,) + STATE_SHAPES[k], dev)
              for k in STATE_SHAPES if k not in ("ids", "n_ids")}
        if rays is not None:
            st["o"].copy_(rays[0])
            st["d"].copy_(rays[1])
        first = None
        if make_list:
            first = (_arg("ray_init: out['ids']", out["ids"], torch.int32,
                          (n,), dev),
                     _arg("ray_init: out['n_ids']", out["n_ids"], torch.int32,
                          (1,), dev))
    else:
        o, d = rays if rays is not None else (torch.empty((n, 3), **f32),
                                              torch.empty((n, 3), **f32))
        st = {"o": o, "d": d,
              "surf": (surface_rgba if surface_rgba is not None
                       else torch.empty((n, 4), **f32)),
              "t_surf": (t_surface if t_surface is not None
                         else torch.empty(n, **f32)),
              "t_start": torch.empty(n, **f32), "t": torch.empty(n, **f32),
              "rgba": torch.empty((n, 4), **f32),
              "depth": torch.empty(n, **f32),
              "max_weight": torch.empty(n, **f32),
              "alive": torch.empty(n, **b8),
              "surf_a": torch.empty(n, **f32), "wn": torch.empty(n, **f32)}
        first = None
        if make_list:
            first = (torch.empty(n, dtype=torch.int32, device=dev),
                     torch.empty(1, dtype=torch.int32, device=dev))
    f32n = np.float32
    params = InitParams(
        ox=f32n(offsets[0]), oy=f32n(offsets[1]), inv_w=f32n(1) / f32n(width),
        inv_h=f32n(1) / f32n(height), cone=f32n(opts.cone_angle),
        dt_min=f32n(C.MIN_CONE_STEPSIZE), dt_max=f32n(C.MAX_CONE_STEPSIZE),
        width=width, height=height, jitter=int(opts.jitter),
        max_cascade=opts.config.max_cascade,
        lowres_f=f if coarse is not None else 0,
        coarse_w=coarse[0].shape[1] if coarse is not None else 0,
        make_list=int(make_list), seed=jitter_seed(sample_index))
    given = 0
    if rays is None:
        params.cam[:] = cam.reshape(-1).tolist()
        params.eye[:] = (cam[:, 3] + f32n(0.5)).tolist()
    else:
        given = STAGE_GIVEN
    ptrs = {"box_lo": box[0], "box_hi": box[1], "surf_in": surface_rgba,
            "t_surf_in": t_surface, "o": st["o"], "d": st["d"],
            "surf": st["surf"], "t_surf": st["t_surf"]}
    if coarse is not None:
        ptrs.update(t_floor=coarse[0], alive_img=coarse[1])
    state = {k: st[k] for k in ("t", "t_start", "rgba", "depth", "max_weight",
                                "wn", "surf_a", "alive")}
    if first is not None:
        state.update(ids=first[0], n_ids=first[1])
    walk = opts.init_skip_iters > 0
    if not walk:
        params.stage = STAGE_RAYS | STAGE_STATE | given
        ptrs.update(state)
        _launch("ray_init", lib.nmr_ray_init, dev, ctypes.byref(params),
                ctypes.byref(InitArgs(**{k: _ptr(v) for k, v in ptrs.items()})))
        return st, first
    # init_rays' walk between the rays and the state
    t_pre, alive_pre = torch.empty(n, **f32), torch.empty(n, **b8)
    params.stage = STAGE_RAYS | given
    _launch("ray_init", lib.nmr_ray_init, dev, ctypes.byref(params),
            ctypes.byref(InitArgs(**{k: _ptr(v) for k, v in ptrs.items()},
                                  t_pre=t_pre.data_ptr(),
                                  alive_pre=alive_pre.data_ptr())))
    t_walk, alive_walk = march_cuda.init_walk(st["o"], st["d"], t_pre,
                                              st["t_surf"], alive_pre, scene,
                                              opts)
    params.stage = STAGE_STATE
    ptrs.update(state, t_walk=t_walk, alive_walk=alive_walk)
    _launch("ray_init", lib.nmr_ray_init, dev, ctypes.byref(params),
            ctypes.byref(InitArgs(**{k: _ptr(v) for k, v in ptrs.items()})))
    return st, first


# ---------------------------------------------------------------------------
# nmr_frame_finalize: _finalize and _shade_frame in one pass
# ---------------------------------------------------------------------------

def finalize_state(st):
    rgba = st["rgba"]
    _plain("finalize", rgba)
    keep = rgba[:, 3] > 0.001   # compact_kernel_nerf's w > 0.001 filter
    rgba = torch.where(keep[:, None], rgba, 0.0)
    # depth only where the splat alpha exceeds 0.2 (shade_kernel_nerf,
    # testbed.cu:927-929); else the cleared 0
    depth = torch.where(rgba[:, 3] > 0.2, st["depth"], 0.0)
    return {"rgba": rgba, "depth": depth}


def shade_frame(rgba, linear_colors: bool):
    if linear_colors:
        return rgba
    return torch.cat([srgb_to_linear(rgba[..., :3]), rgba[..., 3:]], dim=-1)


def finalize_reference(rgba, depth, width: int, height: int,
                       linear_colors: bool):
    """Plain version of nmr_frame_finalize (_finalize, then _shade_frame)."""
    out = finalize_state({"rgba": rgba, "depth": depth})
    return (shade_frame(out["rgba"].reshape(height, width, 4), linear_colors),
            out["depth"].reshape(height, width))


def finalize(rgba, depth, width: int, height: int, linear_colors: bool):
    """The march's accumulated rgba (N, 4) and depth (N,), N = width *
    height row-major -> (frame (H, W, 4): the w > 0.001 keep, the colour
    sRGB -> linear unless linear_colors; depth (H, W): the depth where the
    kept alpha exceeds 0.2, else 0). On a CUDA tensor one launch of
    nmr_frame_finalize."""
    dev = rgba.device
    kernel = _route("finalize", rgba)
    n = width * height
    rgba = _arg("finalize: rgba", rgba, torch.float32, (n, 4), dev)
    depth = _arg("finalize: depth", depth, torch.float32, (n,), dev)
    if not kernel:
        return finalize_reference(rgba, depth, width, height, linear_colors)
    lib = load_library()
    frame = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    depth_out = torch.empty((height, width), dtype=torch.float32, device=dev)
    f = np.float32
    params = FinalizeParams(n=n, linear=int(linear_colors), keep_a=f(0.001),
                            depth_a=f(0.2), lin_cut=f(0.04045),
                            inv_1292=f(1) / f(12.92), add=f(0.055),
                            inv_1055=f(1) / f(1.055), gamma=f(2.4))
    args = FinalizeArgs(rgba_in=rgba.data_ptr(), depth_in=depth.data_ptr(),
                        rgba=frame.data_ptr(), depth=depth_out.data_ptr())
    if n:
        _launch("finalize", lib.nmr_frame_finalize, dev, ctypes.byref(params),
                ctypes.byref(args))
    return frame, depth_out


# ---------------------------------------------------------------------------
# The contract
# ---------------------------------------------------------------------------

def _allowed(n):
    return max(MISMATCH_MIN, math.ceil(MISMATCH_FRACTION * n))


def _rel_err(a, b, mask=None):
    """max |a - b| / max(1, |b|) (over mask's rows where given)."""
    if mask is not None:
        a, b = a[mask], b[mask]
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / torch.clamp(b.abs(), min=1.0)).max())


def _abs_err(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def compare_with_plain(kind: str, out_k, out_p, scale=None,
                       walk=False) -> dict:
    """A kernel's outputs against its plain version's on the same inputs
    -> the differences and `ok` under the contract (the module's head).
    kind: "mesh_plan" (dicts), "surface_shade" ((colour, depth)),
    "ray_init" ((state, first)), "finalize" ((frame, depth)). scale: the
    surface shade's shade_error_scale on a textured mesh, or None (flat
    SHADE_ATOL on every pixel). walk: whether the ray init ran its init
    walk (march_cuda.init_walk), else its t is held like its other
    floats."""
    if kind == "mesh_plan":
        ck, cp = out_k["tile_counts"], out_p["tile_counts"]
        counts = bool(torch.equal(ck, cp))
        listed = (torch.arange(out_p["tile_lists"].shape[1],
                               device=cp.device)[None] < cp[:, None])
        rows = ((out_k["tile_lists"] != out_p["tile_lists"]) & listed).any(1)
        lists = counts and not bool(rows.any())
        # the rays of the tiles with candidates (the kernel writes no other)
        busy = cp > 0

        def tile_rays(x):
            return x.reshape(cp.shape[0], -1, 3)[busy]

        rays = max(_rel_err(tile_rays(out_k[k]), tile_rays(out_p[k]))
                   for k in ("o", "d"))
        tris = _rel_err(out_k["tri_scalars"], out_p["tri_scalars"])
        return {"lists_equal": lists, "counts_equal": counts,
                "list_rows_differing": int(rows.sum()),
                "busy_tiles": int(busy.sum()),
                "max_ray_err": rays, "max_tri_err": tris,
                "max_abs_err": max(
                    [_abs_err(tile_rays(out_k[k]), tile_rays(out_p[k]))
                     for k in ("o", "d")]
                    + [_abs_err(out_k["tri_scalars"], out_p["tri_scalars"])]),
                "ok": lists and rays <= PLAN_RTOL and tris <= PLAN_RTOL}
    if kind == "surface_shade":
        diff = (out_k[0] - out_p[0]).abs()
        colour = float(diff.max()) if diff.numel() else 0.0
        over = int((diff > SHADE_ATOL).any(-1).sum())
        depth = bool(torch.equal(out_k[1], out_p[1]))
        out = {"max_colour_err": colour, "depth_equal": depth,
               "pixels_over_atol": over,
               "max_depth_err": _abs_err(out_k[1], out_p[1]),
               "max_abs_err": colour}
        if scale is None:
            return {**out, "ok": over == 0 and depth}
        off = int((diff > SHADE_ATOL + SHADE_COND * scale).any(-1).sum())
        allowed = _allowed(int((out_p[1] > 0).sum()))
        return {**out, "pixels_off": off, "allowed": allowed,
                "max_rounding_scale": float(scale.max()),
                "ok": off <= allowed and depth}
    if kind == "finalize":
        frame = _abs_err(out_k[0], out_p[0])
        depth = bool(torch.equal(out_k[1], out_p[1]))
        return {"max_frame_err": frame, "depth_equal": depth,
                "max_depth_err": _abs_err(out_k[1], out_p[1]),
                "max_abs_err": frame, "ok": frame <= FINALIZE_ATOL and depth}
    if kind != "ray_init":
        raise ValueError(f"unknown kind {kind!r}")
    (sk, fk), (sp, fp) = out_k, out_p
    n = sp["t"].shape[0]
    flags = int((sk["alive"] != sp["alive"]).sum())

    def rel(k):
        return (sk[k] - sp[k]).abs() / torch.clamp(sp[k].abs(), min=1.0)

    # a ray the init walk took a step further or shorter
    walked = (rel("t") > INIT_RTOL) | (rel("t_start") > INIT_RTOL)
    steps = (sk["t"] - sp["t"]).abs()[walked]
    errs = {k: _rel_err(sk[k], sp[k]) for k in
            ("o", "d", "surf", "t_surf", "rgba", "depth", "max_weight",
             "surf_a", "wn")}
    errs.update({k: _rel_err(sk[k], sp[k], ~walked) for k in ("t", "t_start")})
    allowed = _allowed(n) if walk else 0
    out = {"rays": n, "alive": int(sp["alive"].sum()),
           "alive_mismatches": flags, "rays_off": int(walked.sum()),
           "allowed": allowed,
           "max_step": float(steps.max()) if steps.numel() else 0.0,
           "max_state_err": max(errs.values()), "state_errs": errs,
           "max_abs_err": max(_abs_err(sk[k][~walked], sp[k][~walked])
                              for k in errs)}
    ok = (flags == 0 and out["rays_off"] <= allowed
          and out["max_step"] <= march_cuda.STEP_TOL
          and out["max_state_err"] <= INIT_RTOL)
    if fk is not None or fp is not None:
        lk = torch.zeros(n, dtype=torch.bool, device=sk["t"].device)
        lp = torch.zeros_like(lk)
        ck, cp = int(fk[1]), int(fp[1])
        lk[fk[0][:ck].long()] = True
        lp[fp[0][:cp].long()] = True
        own = bool(torch.equal(lk, sk["alive"])) and int(lk.sum()) == ck
        out.update(list_length=ck, list_is_alive_set=own,
                   list_mismatches=int((lk != lp).sum()))
        ok = ok and own and out["list_mismatches"] == 0
    out["ok"] = ok
    return out

"""Mesh pass: tile-culled ray-cast with PBR shading and the fused
supersample reduce — replaces the reference's OptiX pass.

Port of nerf_glasses_tpu/ops/triangles.py. Triangles are binned to
128x64 screen tiles by their projected bounding box; each tile is
ray-cast against its own candidates by the CUDA kernel
(ops/mesh_cuda.py); tiles with any hit are shaded whole and FxF-reduced
into per-pixel payloads (copyRaytracingBuffersToNerfRays,
nerf_mesh_renderer.cu:64-100): colour is the block mean of sRGB +
coverage, depth the max over hits. The mesh pass works in the renderer's
world frame (no +0.5 NGP shift; optix_scene.cu:120-174).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_glasses_tpu_torch.io.gltf import GltfMaterial, GltfNode
from nerf_glasses_tpu_torch.ops import mesh_cuda
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb
from nerf_glasses_tpu_torch.ops.compaction import stable_partition_ids

TILE_W, TILE_H = 128, 64  # screen tile = one ray block of the kernel
_TEX_SLOTS = ("base_color_texture", "metallic_roughness_texture",
              "emissive_texture", "normal_texture", "occlusion_texture")


@dataclasses.dataclass
class MeshArrays:
    """Object-space triangle soup + per-triangle attributes (tensors on
    the renderer's device)."""
    v0: torch.Tensor          # (T, 3)
    e1: torch.Tensor          # (T, 3)  v1 - v0
    e2: torch.Tensor          # (T, 3)  v2 - v0
    n: torch.Tensor           # (T, 3, 3) per-vertex object normals
    tan: torch.Tensor         # (T, 3, 4) per-vertex object tangents
    uv: torch.Tensor          # (T, 3, 2)
    mat_id: torch.Tensor      # (T,) int64
    inst_id: torch.Tensor     # (T,) int64 (indexes instance transforms)
    materials: List[GltfMaterial]
    nodes: List[GltfNode]     # instance i <- nodes[i] (transform source)
    base_color: torch.Tensor       # (M, 4)
    metallic: torch.Tensor         # (M,)
    roughness: torch.Tensor        # (M,)
    emissive: torch.Tensor         # (M, 3)
    normal_scale: torch.Tensor     # (M,)
    occlusion_strength: torch.Tensor  # (M,)
    textures: List[Dict[str, torch.Tensor]]  # per material, uploaded once

    @property
    def n_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def n_instances(self) -> int:
        return len(self.nodes)


def _walk_nodes(scenes):
    """Yield (node, parent_transform) depth-first in a stable order."""
    def rec(node, parent):
        yield node, parent
        x = parent @ node.get_transform()
        for c in node.children:
            yield from rec(c, x)

    for scene in scenes:
        for node in scene.nodes:
            yield from rec(node, np.eye(4, dtype=np.float32))


def build_mesh_arrays(scenes, device="cpu") -> Optional[MeshArrays]:
    """Flatten glTF scenes into an object-space soup with instance ids."""
    v0s, e1s, e2s, ns, tans, uvs, mids, iids = [], [], [], [], [], [], [], []
    materials: List[GltfMaterial] = []
    nodes: List[GltfNode] = []
    for node, _parent in _walk_nodes(scenes):
        if node.mesh is None:
            continue
        iid = len(nodes)
        nodes.append(node)
        for prim in node.mesh.primitives:
            tri = prim.indices.reshape(-1, 3)
            v = prim.positions[tri]
            v0s.append(v[:, 0])
            e1s.append(v[:, 1] - v[:, 0])
            e2s.append(v[:, 2] - v[:, 0])
            ns.append(prim.normals[tri])
            tans.append(prim.tangents[tri])
            uvs.append(prim.texcoords[tri])
            mids.append(np.full(len(tri), len(materials), np.int64))
            iids.append(np.full(len(tri), iid, np.int64))
            materials.append(prim.material)
    if not v0s:
        return None

    def t(parts, dtype=torch.float32):
        a = np.concatenate(parts) if isinstance(parts, list) else parts
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return MeshArrays(
        v0=t(v0s), e1=t(e1s), e2=t(e2s), n=t(ns), tan=t(tans), uv=t(uvs),
        mat_id=t(mids, torch.int64), inst_id=t(iids, torch.int64),
        materials=materials, nodes=nodes,
        base_color=t(np.stack([m.base_color_factor for m in materials])),
        metallic=t(np.array([m.metallic_factor for m in materials])),
        roughness=t(np.array([m.roughness_factor for m in materials])),
        emissive=t(np.stack([m.emissive_factor for m in materials])),
        normal_scale=t(np.array([m.normal_scale for m in materials])),
        occlusion_strength=t(np.array([m.occlusion_strength
                                       for m in materials])),
        textures=[{s: t(getattr(m, s)) for s in _TEX_SLOTS
                   if getattr(m, s) is not None} for m in materials])


def instance_transforms(mesh: MeshArrays, scenes
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Current composed world transforms per instance -> (xforms (I,3,4),
    normal matrices (I,3,3)), host numpy."""
    node_to_xform = {}
    for node, parent in _walk_nodes(scenes):
        node_to_xform[id(node)] = parent @ node.get_transform()
    xf = np.stack([node_to_xform[id(n)][:3, :4] for n in mesh.nodes])
    nrm = np.stack([np.linalg.inv(x[:3, :3]).T for x in xf])
    return xf.astype(np.float32), nrm.astype(np.float32)


def world_triangles(mesh: MeshArrays, xforms: torch.Tensor):
    """The object-space soup through each triangle's instance transform
    (xforms (I, 3, 4) on the mesh's device) -> world (v0, e1, e2), (T, 3)
    each."""
    rot = xforms[mesh.inst_id, :, :3]
    return (torch.einsum("tij,tj->ti", rot, mesh.v0)
            + xforms[mesh.inst_id, :, 3],
            torch.einsum("tij,tj->ti", rot, mesh.e1),
            torch.einsum("tij,tj->ti", rot, mesh.e2))


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------

def _raycast_chunked(o, d, v0, e1, e2, chunk: int = 256):
    """Brute-force back-face-culled ray-cast of every ray against every
    (world-space) triangle, `chunk` triangles at a time -> (t, tri_idx,
    uv (N, 2)); the plain reference the tiled pass is held against."""
    t, i, u, v = mesh_cuda.raycast_reference(torch.cat([v0, e1, e2], dim=1),
                                             o, d, tri_chunk=chunk)
    return t, i, torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# Shading (closesthit PBR, optix_scene.cu:182-325)
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def _sample_texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
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


def shade_hits(mesh: MeshArrays, o, d, t, tri, uv_bary, nrm_mats,
               light_pos, cam_eye):
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
            texv = _sample_texture(tex["base_color_texture"], uv)
            base = torch.where(mmask, base * texv, base)
        if "metallic_roughness_texture" in tex:
            mr = _sample_texture(tex["metallic_roughness_texture"], uv)
            metallic = torch.where(mmask[:, 0], metallic * mr[:, 2], metallic)
            roughness = torch.where(mmask[:, 0], roughness * mr[:, 1],
                                    roughness)
        if "emissive_texture" in tex:
            ev = _sample_texture(tex["emissive_texture"], uv)
            emissive = torch.where(mmask, emissive * ev[:, :3], emissive)
        if "normal_texture" in tex:
            nt = _sample_texture(tex["normal_texture"], uv)
            ns = mesh.normal_scale[mid]
            ntan = (nt[:, :3] * 2.0 - 1.0) * torch.stack(
                [ns, ns, torch.ones_like(metallic)], -1)
            mapped = (tng * ntan[:, 0:1] + btn * ntan[:, 1:2]
                      + nrm * ntan[:, 2:3])
            normal = torch.where(mmask, mapped, normal)
        if "occlusion_texture" in tex:
            ot = _sample_texture(tex["occlusion_texture"], uv)
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


def shade_hits_compacted(mesh: MeshArrays, o, d, t, tri, uv_bary, nrm_mats,
                         light_pos, cam_eye):
    """shade_hits for the rays that hit a triangle only (mesh coverage is
    a small share of the screen) -> (N, 3), zeros at misses. The JAX
    package shades fixed-size chunks of the compacted hit ids; the port
    shades them as one batch."""
    rgb = torch.zeros((t.shape[0], 3), device=t.device)
    ids = torch.nonzero(tri >= 0).squeeze(1)
    if ids.numel():
        rgb[ids] = shade_hits(mesh, o[ids], d[ids], t[ids], tri[ids],
                              uv_bary[ids], nrm_mats, light_pos, cam_eye)
    return rgb


# ---------------------------------------------------------------------------
# Binning and the tiled pass
# ---------------------------------------------------------------------------

def _bin_triangles(v0, e1, e2, eye, cam3_inv, width: int, height: int,
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


def tiled_raycast_inputs(mesh: MeshArrays, xforms, camera, width: int,
                         height: int):
    """Everything the tiled ray-cast takes for a (width, height) pass ->
    dict with tri_scalars (T, 9), tile-major rays o, d (n_tiles*8192, 3),
    tile_lists, tile_counts, the camera eye and the tile grid (ntx, nty)."""
    dev = mesh.v0.device
    f32 = dict(dtype=torch.float32, device=dev)
    wp = -(-width // TILE_W) * TILE_W
    hp = -(-height // TILE_H) * TILE_H
    ntx, nty = wp // TILE_W, hp // TILE_H
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
    lists, counts = _bin_triangles(v0, e1, e2, eye, torch.linalg.inv(cam3),
                                   width, height, wp, hp)
    return {"tri_scalars": torch.cat([v0, e1, e2], dim=1).contiguous(),
            "o": eye.expand(d_t.shape).contiguous(), "d": d_t,
            "tile_lists": lists, "tile_counts": counts, "eye": eye,
            "ntx": ntx, "nty": nty}


def render_mesh_pass_tiled(mesh: MeshArrays, xforms, nrm_mats, camera,
                           width: int, height: int, light_pos,
                           factor: int = 1):
    """Tile-culled mesh pass at (width, height) with the FxF payload
    reduce fused in -> (color (H/F, W/F, 4) sRGB + coverage, depth
    (H/F, W/F) max hit distance, 0 where nothing was hit)."""
    if TILE_W % factor or TILE_H % factor:
        raise ValueError(f"factor {factor} must divide the {TILE_W}x{TILE_H} tile")
    dev = mesh.v0.device
    f32 = dict(dtype=torch.float32, device=dev)
    nrm_mats = torch.as_tensor(np.asarray(nrm_mats), **f32)
    light = torch.as_tensor(np.asarray(light_pos, np.float32), **f32)
    inp = tiled_raycast_inputs(mesh, xforms, camera, width, height)
    eye, d_t, ntx, nty = inp["eye"], inp["d"], inp["ntx"], inp["nty"]
    t, tri, uu, vv = mesh_cuda.raycast_tiled(
        inp["tri_scalars"], inp["o"], d_t, inp["tile_lists"],
        inp["tile_counts"])

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


def render_mesh_pass(mesh: MeshArrays, xforms, nrm_mats, camera,
                     width: int, height: int, light_pos, tri_chunk: int = 256,
                     ray_tile: int = 262144, device_out: bool = False):
    """Trace and shade the mesh at (width, height) in the renderer's world
    frame -> (color (H, W, 4) sRGB + coverage alpha, depth (H, W) hit
    distance, 0 on a miss), numpy, or tensors with device_out.

    On the card this is the tiled pass (render_mesh_pass_tiled, one
    launch of the tiled kernel), as the JAX package takes on its chip;
    on the CPU the plain route: every ray against every triangle
    (_raycast_chunked, `tri_chunk` triangles at a time) in tiles of
    `ray_tile` rays, each shaded whole."""
    dev = mesh.v0.device
    if dev.type == "cuda":
        color, depth = render_mesh_pass_tiled(mesh, xforms, nrm_mats, camera,
                                              width, height, light_pos)
    else:
        f32 = dict(dtype=torch.float32, device=dev)
        cam = torch.as_tensor(np.asarray(camera, np.float32), **f32)
        xf = torch.as_tensor(np.asarray(xforms, np.float32), **f32)
        nm = torch.as_tensor(np.asarray(nrm_mats, np.float32), **f32)
        light = torch.as_tensor(np.asarray(light_pos, np.float32), **f32)
        eye = cam[:, 3]
        x = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
        y = (torch.arange(height, **f32) + 0.5) / height * 2.0 - 1.0
        ndc = torch.stack([x[None].expand(height, width),
                           y[:, None].expand(height, width),
                           torch.ones((height, width), **f32)], dim=-1)
        d = (ndc @ cam[:, :3].T).reshape(-1, 3)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        o = eye.expand(d.shape)
        v0, e1, e2 = world_triangles(mesh, xf)
        colors, depths = [], []
        for s in range(0, d.shape[0], ray_tile):
            ot, dt = o[s:s + ray_tile], d[s:s + ray_tile]
            t, tri, uv = _raycast_chunked(ot, dt, v0, e1, e2, tri_chunk)
            rgb = shade_hits(mesh, ot, dt, t, tri, uv, nm, light, eye)
            hit = tri >= 0
            colors.append(torch.cat([
                linear_to_srgb(torch.clamp(rgb, 0.0, 1.0)),
                hit[:, None].float()], -1))
            depths.append(torch.where(hit, t, 0.0))
        color = torch.cat(colors).reshape(height, width, 4)
        depth = torch.cat(depths).reshape(height, width)
    if device_out:
        return color, depth
    return color.cpu().numpy(), depth.cpu().numpy()


def render_mesh_surface(mesh: MeshArrays, xforms, nrm_mats, camera,
                        width: int, height: int, factor: int, light_pos):
    """Mesh pass at (width*factor, height*factor) supersampling, reduced
    to per-NeRF-pixel (surface_color (H, W, 4), t_surface (H, W))."""
    return render_mesh_pass_tiled(mesh, xforms, nrm_mats, camera,
                                  width * factor, height * factor,
                                  light_pos, factor=factor)


def downsample_surface(color: torch.Tensor, depth: torch.Tensor, factor: int):
    """Block-reduce supersampled mesh buffers into per-pixel payloads:
    color = mean, depth = max of hit depths."""
    h, w = depth.shape
    hh, ww = h // factor, w // factor
    c = color.reshape(hh, factor, ww, factor, 4).mean(dim=(1, 3))
    dmax = depth.reshape(hh, factor, ww, factor).amax(dim=(1, 3))
    return c, dmax

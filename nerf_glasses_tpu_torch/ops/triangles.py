"""Mesh pass: tile-culled ray-cast with PBR shading and the fused
supersample reduce — replaces the reference's OptiX pass.

Port of nerf_glasses_tpu/ops/triangles.py. Triangles are binned to
128x64 screen tiles by their projected bounding box and the tile-major
rays made (ops/frame_cuda.py::mesh_plan); each tile is ray-cast against
its own candidates by the CUDA kernel (ops/mesh_cuda.py); the hits are
shaded and FxF-reduced into per-pixel payloads
(frame_cuda.surface_shade; copyRaytracingBuffersToNerfRays,
nerf_mesh_renderer.cu:64-100): colour is the block mean of sRGB +
coverage, depth the max over hits. The mesh pass works in the renderer's
world frame (no +0.5 NGP shift; optix_scene.cu:120-174).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_glasses_tpu_torch.io.gltf import GltfMaterial, GltfNode
from nerf_glasses_tpu_torch.ops import frame_cuda, mesh_cuda
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb
# the plain versions of the frame kernels' stages live with the kernels
from nerf_glasses_tpu_torch.ops.frame_cuda import (  # noqa: F401
    TILE_H, TILE_W, bin_triangles as _bin_triangles, shade_hits,
    world_triangles)


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
    textures: List[Dict[str, torch.Tensor]]  # per material, views of texels
    # the materials as the surface-shade kernel reads them
    # (frame_cuda.pack_materials): factors (M, 12), texture slots
    # (M, 5, 4) i32, all texels in one buffer
    mat_table: torch.Tensor
    tex_table: torch.Tensor
    texels: torch.Tensor

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

    mat_table, tex_table, texels, textures = frame_cuda.pack_materials(
        materials, device)
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
        textures=textures, mat_table=mat_table, tex_table=tex_table,
        texels=texels)


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
# Shading (closesthit PBR, optix_scene.cu:182-325): frame_cuda.shade_hits
# ---------------------------------------------------------------------------

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

def tiled_raycast_inputs(mesh: MeshArrays, xforms, camera, width: int,
                         height: int):
    """Everything the tiled ray-cast takes for a (width, height) pass ->
    dict with tri_scalars (T, 9), tile-major rays o, d (n_tiles*8192, 3),
    tile_lists, tile_counts and the tile grid (ntx, nty): frame_cuda.
    mesh_plan (one kernel launch on the card)."""
    return frame_cuda.mesh_plan(mesh, xforms, camera, width, height)


def render_mesh_pass_tiled(mesh: MeshArrays, xforms, nrm_mats, camera,
                           width: int, height: int, light_pos,
                           factor: int = 1):
    """Tile-culled mesh pass at (width, height) with the FxF payload
    reduce fused in -> (color (H/F, W/F, 4) sRGB + coverage, depth
    (H/F, W/F) max hit distance, 0 where nothing was hit). On the card
    three kernels: the plan (frame_cuda.mesh_plan), the tiled ray-cast,
    the shade and reduce (frame_cuda.surface_shade)."""
    if TILE_W % factor or TILE_H % factor:
        raise ValueError(f"factor {factor} must divide the {TILE_W}x{TILE_H} tile")
    plan = frame_cuda.mesh_plan(mesh, xforms, camera, width, height)
    hits = mesh_cuda.raycast_tiled(plan["tri_scalars"], plan["o"], plan["d"],
                                   plan["tile_lists"], plan["tile_counts"])
    return frame_cuda.surface_shade(mesh, plan, hits, nrm_mats, light_pos,
                                    camera, width, height, factor)


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

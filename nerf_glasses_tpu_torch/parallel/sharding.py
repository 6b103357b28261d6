"""The hybrid frame as one row-sharded program.

Port of nerf_glasses_tpu/parallel/sharding.py::make_hybrid_frame_sharded
and render_hybrid_sharded. The frame's pixel rows are cut into n_shards
equal bands; each band runs the JAX package's per-shard body end to end:
the mesh pass for its rows at `supersample` resolution with the untiled
ray-cast kernel (mesh_cuda.raycast), shade_hits_compacted and the block
reduce into surface payloads, then the compacting march on its rays. The
flash coarse init is computed once over the whole frame, so its min
filter sees no shard seams.

Where the JAX package takes a device Mesh, the port takes `n_shards`, and
one process runs the shards one after another on its one device
(n_shards=1 is the JAX package's make_mesh(1)); spreading them over GPUs
with torch.distributed is ROADMAP queue 1 item 13. Rays are generated
with elementwise arithmetic rather than a matrix product, so a ray's
direction does not depend on how many rays share its batch and the frame
does not depend on the shard count (jitter, which uses shard-local ray
ids as in the JAX package, aside).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_glasses_tpu_torch.ops import mesh_cuda
from nerf_glasses_tpu_torch.ops import triangles as tri_ops
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb
from nerf_glasses_tpu_torch.ops.raymarch import (_shade_frame, flash_init,
                                                 march_frame_impl,
                                                 upsample_flash_init)


def _dirs(cam, x, y):
    """NDC x (W,), y (H,) -> unit directions (H*W, 3) of cam[:, :3] @
    (x, y, 1), row-major."""
    xx = x[None, :, None]
    yy = y[:, None, None]
    d = (xx * cam[:, 0] + yy * cam[:, 1] + cam[:, 2]).reshape(-1, 3)
    dx, dy, dz = d.unbind(-1)
    return d / torch.sqrt(dx * dx + dy * dy + dz * dz)[:, None]


def make_hybrid_frame_sharded(n_shards: int, tri_mesh: tri_ops.MeshArrays,
                              opts, width: int, height: int,
                              supersample: int = 2):
    """-> fn(net, scene, xforms, nrm_mats, cam, light, pix_offset) ->
    (frame (H, W, 4) linear premultiplied, depth (H, W)) tensors on the
    scene's device, rendering the hybrid frame in n_shards row bands."""
    if height % n_shards:
        raise ValueError(f"height {height} is not a multiple of n_shards "
                         f"{n_shards}")
    rows = height // n_shards
    f = supersample
    flash = opts.lowres_factor > 1

    def local(net, scene, tri_world, nrm_mats, cam, light, pix_offset, row0,
              t_floor, alive):
        dev = cam.device
        eye = cam[:, 3]
        # ---- mesh pass for my rows at supersample resolution ----
        px = torch.arange(width * f, dtype=torch.float32, device=dev) + 0.5
        py = (torch.arange(rows * f, dtype=torch.float32, device=dev)
              + row0 * f + 0.5)
        d_m = _dirs(cam, px / (width * f) * 2.0 - 1.0,
                    py / (height * f) * 2.0 - 1.0)
        o_m = eye.expand(d_m.shape).contiguous()
        t, tri, uu, vv = mesh_cuda.raycast(tri_world, o_m, d_m)
        rgb = tri_ops.shade_hits_compacted(tri_mesh, o_m, d_m, t, tri,
                                           torch.stack([uu, vv], -1),
                                           nrm_mats, light, eye)
        hit = tri >= 0
        color = torch.cat([linear_to_srgb(torch.clamp(rgb, 0.0, 1.0)),
                           hit[:, None].float()], -1)
        surf_c, surf_t = tri_ops.downsample_surface(
            color.reshape(rows * f, width * f, 4),
            torch.where(hit, t, 0.0).reshape(rows * f, width * f), f)

        # ---- volumetric march on my rows ----
        gx = torch.arange(width, dtype=torch.float32, device=dev)
        gy = torch.arange(rows, dtype=torch.float32, device=dev) + row0
        d = _dirs(cam, (gx + pix_offset[0]) / width * 2.0 - 1.0,
                  (gy + pix_offset[1]) / height * 2.0 - 1.0)
        o = (cam[:, 3] + 0.5).expand(d.shape)
        out, _ = march_frame_impl(net, scene, o, d, surf_c.reshape(-1, 4),
                                  surf_t.reshape(-1), opts,
                                  t_floor=t_floor, alive_mask=alive)
        return (_shade_frame(out["rgba"].reshape(rows, width, 4), False),
                out["depth"].reshape(rows, width))

    def full(net, scene, xforms, nrm_mats, cam, light, pix_offset):
        dev = scene["occ"].device
        f32 = dict(dtype=torch.float32, device=dev)
        cam = torch.as_tensor(np.asarray(cam, np.float32), **f32)
        xforms = torch.as_tensor(np.asarray(xforms, np.float32), **f32)
        nrm_mats = torch.as_tensor(np.asarray(nrm_mats, np.float32), **f32)
        light = torch.as_tensor(np.asarray(light, np.float32), **f32)
        rot = xforms[tri_mesh.inst_id, :, :3]
        trans = xforms[tri_mesh.inst_id, :, 3]
        tri_world = torch.cat([
            torch.einsum("tij,tj->ti", rot, tri_mesh.v0) + trans,
            torch.einsum("tij,tj->ti", rot, tri_mesh.e1),
            torch.einsum("tij,tj->ti", rot, tri_mesh.e2)], dim=1).contiguous()
        t_up = a_up = None
        if flash:
            tmin, alive_img = flash_init(scene, cam, width, height, opts)
            t_up, a_up = upsample_flash_init(tmin, alive_img, width, height,
                                             opts.lowres_factor)
        frames, depths = [], []
        for s in range(n_shards):
            band = slice(s * rows * width, (s + 1) * rows * width)
            fr, dp = local(net, scene, tri_world, nrm_mats, cam, light,
                           pix_offset, s * rows,
                           None if t_up is None else t_up[band],
                           None if a_up is None else a_up[band])
            frames.append(fr)
            depths.append(dp)
        return torch.cat(frames), torch.cat(depths)

    return full


@torch.no_grad()
def render_hybrid_sharded(net, scene, tri_mesh, xforms, nrm_mats, camera,
                          width: int, height: int, opts, n_shards: int = 1,
                          light_pos=(1.0, 1.0, 1.0), pix_offset=(0.5, 0.5)):
    """Full hybrid frame (mesh pass + flash init + march) in n_shards row
    bands -> (frame (H, W, 4) linear premultiplied, depth (H, W)) numpy.
    Builds no autograd graph, also for a network that trains."""
    fn = make_hybrid_frame_sharded(n_shards, tri_mesh, opts, width, height)
    frame, depth = fn(net, scene, xforms, nrm_mats, camera, light_pos,
                      pix_offset)
    return frame.cpu().numpy(), depth.cpu().numpy()

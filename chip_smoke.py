"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py

Drives the port's main path, the hybrid frame, the way a user calls it:
NerfMeshRenderer(1280, 720).load_nerf(trained snapshot) + load_mesh(a
procedural glasses glTF written here) + frame(), with the mesh pass at
2x supersampling. Phases:

  1. a CUDA device must be present;
  2. card, power limit, torch/CUDA versions; build the mesh ray-cast
     kernel from nerf_glasses_tpu_torch/csrc (timed);
  3. the kernel against its plain PyTorch version at the main path's
     shapes (2560x1440 rays, tile-padded to 2560x1472, binned against
     the glasses): hit mask and ids equal, max |dt| on shared hits
     <= 1e-6, both timed;
  4. the slice: 1 warm-up + 3 timed frames at 1280x720; the frame is
     finite, the head covers a plausible share, mesh pixels are present
     and the kernel was launched by the frames (its launch count is
     zeroed just before and read just after);
  5. one frame with the plain ray-cast in the kernel's place: >= 50 dB
     PSNR against the kernel's frame at the same sample index;
  6. a small frame (160x90) rendered on the card and on the CPU (the CPU
     takes the plain ray-cast; the CPU port is held against the JAX
     package by tests/test_torch_*.py): >= 40 dB PSNR;
  7. the untiled ray-cast kernel against its plain version on the 2560x
     1440 mesh rays of the smoke camera: every 8th row compared (hit mask
     and ids equal, max |dt| <= 1e-6), the kernel timed on all rays, the
     plain version on the compared rows;
  8. the flash frame through the renderer: load_nerf(bake=True) at the
     defaults (512^3 sigma, 256^3 features, fidelity probe "ok"), 1 warm-up
     + 3 timed 720p frames on last_render_path "flash" (the tiled kernel
     launched), >= 30 dB PSNR against the exact frame of phase 4's
     renderer at the same camera and sample index;
  9. the single-program hybrid frame (render_hybrid_sharded, n_shards=1)
     with that Testbed's flash options and scene: the untiled kernel
     launched, the frame finite and >= 40 dB from the renderer's flash
     frame at the same pixel offset; with jitter off, n_shards=4 equals
     n_shards=1 to 1e-5;
 10. a 160x90 flash frame (bake 128, float32 MLPs) on the card and on the
     CPU: >= 40 dB PSNR.

Prints one JSON line with the kernels' numbers, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. Exits non-zero
on any failure, when no CUDA device is present, and when the package is
not beside it.
"""

import base64
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer
from nerf_glasses_tpu_torch.ops import mesh_cuda
from nerf_glasses_tpu_torch.ops import triangles as tri_ops
from nerf_glasses_tpu_torch.parallel.sharding import render_hybrid_sharded

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "assets", "trained", "trained_head_v6.msgpack")
W, H = 1280, 720
KERNEL_T_TOL = 1e-6     # kernel and plain version agree bit for bit
                        # (-fmad=false, same operation order)
PSNR_PLAIN_DB = 50.0
PSNR_CPU_DB = 40.0
PSNR_FLASH_VS_EXACT_DB = 30.0   # the package's own bake-probe threshold
PSNR_SHARDED_DB = 40.0
SHARD_ATOL = 1e-5               # tests/test_parallel.py:141


# ---------------------------------------------------------------------------
# Procedural glasses: two rims, a bridge and two temples as tubes
# ---------------------------------------------------------------------------

def _tube(path, radius, sides, closed):
    """Tube along a polyline -> (positions, normals, indices), outward
    counter-clockwise winding (back faces are culled)."""
    path = np.asarray(path, np.float64)
    m = len(path)
    if closed:
        nxt, prv = np.roll(path, -1, 0), np.roll(path, 1, 0)
    else:
        nxt = np.vstack([path[1:], 2 * path[-1] - path[-2]])
        prv = np.vstack([2 * path[0] - path[1], path[:-1]])
    tang = nxt - prv
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    pos, nrm = [], []
    for p, t in zip(path, tang):
        ref = np.array([0.0, 0.0, 1.0] if abs(t[2]) < 0.9 else [0.0, 1.0, 0.0])
        n = np.cross(t, ref)
        n /= np.linalg.norm(n)
        b = np.cross(t, n)
        for j in range(sides):
            a = 2.0 * math.pi * j / sides
            dirv = math.cos(a) * n + math.sin(a) * b
            pos.append(p + radius * dirv)
            nrm.append(dirv)
    idx = []
    rings = m if closed else m - 1
    for i in range(rings):
        i2 = (i + 1) % m
        for j in range(sides):
            j2 = (j + 1) % sides
            a, b, c, d = i * sides + j, i * sides + j2, i2 * sides + j, i2 * sides + j2
            idx += [a, b, c, b, d, c]
    return np.asarray(pos, np.float32), np.asarray(nrm, np.float32), idx


def write_glasses_gltf(path):
    """About 3.3k triangles in glasses units (x across, y up, z toward the
    viewer; temples run back along -z)."""
    parts = []
    for sx in (-1.0, 1.0):
        a = np.linspace(0.0, 2.0 * math.pi, 48, endpoint=False)
        rim = np.stack([sx * 0.55 + 0.45 * np.cos(a), 0.36 * np.sin(a),
                        np.zeros_like(a)], 1)
        parts.append(_tube(rim, 0.04, 12, closed=True))
        s = np.linspace(0.0, 1.0, 24)
        temple = np.stack([np.full_like(s, sx * 1.0), 0.1 + 0.0 * s,
                           -0.05 - 1.6 * s - 0.2 * s ** 4], 1)
        temple[:, 1] -= 0.25 * s ** 6
        parts.append(_tube(temple, 0.035, 8, closed=False))
    a = np.linspace(math.pi * 0.15, math.pi * 0.85, 16)
    bridge = np.stack([-0.12 * np.cos(a) / np.cos(math.pi * 0.15),
                       0.12 + 0.08 * np.sin(a), np.zeros_like(a)], 1)
    parts.append(_tube(bridge, 0.03, 8, closed=False))
    pos, nrm, idx, off = [], [], [], 0
    for p, n, i in parts:
        pos.append(p)
        nrm.append(n)
        idx += [k + off for k in i]
        off += len(p)
    pos = np.concatenate(pos)
    nrm = np.concatenate(nrm)
    idx = np.asarray(idx, np.uint32)
    buf = pos.tobytes() + nrm.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "glasses"}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1},
            "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.12, 0.1, 0.1, 1.0],
            "metallicFactor": 0.6, "roughnessFactor": 0.35}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3", "min": pos.min(0).tolist(),
             "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(pos),
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": nrm.nbytes},
            {"buffer": 0, "byteOffset": 2 * pos.nbytes,
             "byteLength": idx.nbytes}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(idx) // 3


def make_renderer(device, width, height, glasses, **load_kw):
    """The trained head with the glasses placed on it, camera as the
    repository's bench places it; load_kw goes to load_nerf (bake=...)."""
    r = NerfMeshRenderer(width, height, device=device)
    nerf = r.load_nerf(SNAPSHOT, **load_kw)
    nerf.render_aabb.min = np.array([0.1, 0.1, 0.1], np.float32)
    nerf.render_aabb.max = np.array([0.9, 0.9, 0.9], np.float32)
    if r.load_mesh(glasses, t=[0.0, 0.1, 0.22], s=[0.25, 0.25, 0.25]) is None:
        raise RuntimeError("the glasses glTF did not load")
    r.orbit(0.4, -0.1, 0)
    r.orbit(0, 0, 3.5)
    return r, nerf


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(tmp):
    # 1
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    mesh_cuda.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {mesh_cuda.build_seconds:.2f} s)")
    print(mesh_cuda.build_log.strip())

    glasses = os.path.join(tmp, "glasses.gltf")
    n_tris = write_glasses_gltf(glasses)
    renderer, nerf = make_renderer(dev, W, H, glasses)
    print(f"glasses: {n_tris} triangles")

    # 3: kernel against plain at the main path's shapes
    f = renderer.mesh_render_size_factor
    xf, _ = tri_ops.instance_transforms(renderer._mesh_arrays, renderer._meshes)
    inp = tri_ops.tiled_raycast_inputs(renderer._mesh_arrays, xf,
                                       renderer.view_projection_mat, W * f, H * f)
    args = (inp["tri_scalars"], inp["o"], inp["d"], inp["tile_lists"],
            inp["tile_counts"])
    n_rays, n_tiles = inp["o"].shape[0], inp["tile_counts"].shape[0]
    counts = inp["tile_counts"]
    kt, ki, ku, kv = mesh_cuda.raycast_tiled(*args)
    torch.cuda.synchronize()
    pt, pi, pu, pv = mesh_cuda.raycast_tiled_reference(*args)
    torch.cuda.synchronize()
    hit_k, hit_p = ki >= 0, pi >= 0
    shared = hit_k & hit_p
    mask_diff = int((hit_k != hit_p).sum())
    id_diff = int((ki != pi).sum())
    max_dt = float((kt[shared] - pt[shared]).abs().max()) if shared.any() else 0.0
    max_duv = float(torch.maximum((ku - pu).abs(), (kv - pv).abs()).max())
    k_ms = cuda_ms(lambda: mesh_cuda.raycast_tiled(*args), 20)
    p_ms = cuda_ms(lambda: mesh_cuda.raycast_tiled_reference(*args), 3)
    print(f"ray-cast: {n_rays} rays in {n_tiles} tiles ({W * f}x{H * f}, tile-padded), "
          f"{int((counts > 0).sum())} tiles with candidates, max count "
          f"{int(counts.max())}, {int(hit_p.sum())} hits")
    print(f"ray-cast kernel vs plain: hit-mask mismatches {mask_diff}, id mismatches "
          f"{id_diff}, max |dt| {max_dt:.3g}, max |du|,|dv| {max_duv:.3g}; "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms")
    if not (mask_diff == 0 and id_diff == 0 and max_dt <= KERNEL_T_TOL
            and int(hit_p.sum()) > 0):
        raise AssertionError("kernel disagrees with its plain version")
    del kt, ki, ku, kv, pt, pi, pu, pv, inp, args

    # 4: the slice
    torch.cuda.reset_peak_memory_stats()
    mesh_cuda.launches = 0
    renderer.frame()
    torch.cuda.synchronize()
    warm_ms = renderer.last_frame_ms
    t0 = time.perf_counter()
    epochs = []
    for _ in range(3):
        renderer.frame()
        epochs.append(nerf.last_march_epochs)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1000.0 / 3
    launches = mesh_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    fb = renderer._frame_buffer
    img = renderer.display_image()
    surf_px = int((nerf._surface_t > 0).sum())
    head_share = float((fb[..., 3] > 0.5).float().mean())
    print(f"hybrid {W}x{H}: warm-up frame {warm_ms:.1f} ms, {frame_ms:.1f} ms/frame "
          f"(3 frames, host clock to synchronize), march epochs {epochs}, "
          f"peak device memory {peak / 2**30:.2f} GiB, head share {head_share:.3f}, "
          f"mesh pixels {surf_px}, kernel launches {launches}")
    if not (img.shape == (H, W, 4) and np.isfinite(img).all()
            and bool(torch.isfinite(fb).all())):
        raise AssertionError("frame is not finite or has the wrong shape")
    if not 0.02 <= head_share <= 0.9:
        raise AssertionError(f"implausible head coverage {head_share}")
    if surf_px < 1000:
        raise AssertionError(f"only {surf_px} mesh pixels")
    if launches < 4:
        raise AssertionError(f"main path launched the kernel {launches} times")

    # 5: the plain ray-cast in the kernel's place, same sample index
    renderer.update_model_view_proj()
    renderer.frame()
    img_k = renderer.display_image()
    kernel_fn = mesh_cuda.raycast_tiled
    mesh_cuda.raycast_tiled = mesh_cuda.raycast_tiled_reference
    try:
        before = mesh_cuda.launches
        renderer.update_model_view_proj()
        renderer.frame()
        img_p = renderer.display_image()
    finally:
        mesh_cuda.raycast_tiled = kernel_fn
    if mesh_cuda.launches != before:
        raise AssertionError("the plain-version frame launched the kernel")
    p_plain = psnr(img_k[..., :3], img_p[..., :3])
    print(f"frame with the plain ray-cast vs the kernel: {p_plain:.2f} dB")
    if p_plain < PSNR_PLAIN_DB:
        raise AssertionError("plain ray-cast frame disagrees")

    # 6: a small frame on the card against the CPU
    small = []
    for device in (dev, torch.device("cpu")):
        r, n = make_renderer(device, 160, 90, glasses)
        n.march_overrides = {"compute_dtype": "float32"}
        r.frame()
        small.append(r.display_image())
    p_cpu = psnr(small[0][..., :3], small[1][..., :3])
    print(f"160x90 frame, card vs CPU (float32 MLPs): {p_cpu:.2f} dB")
    if p_cpu < PSNR_CPU_DB:
        raise AssertionError("card and CPU frames disagree")

    # 7: the untiled kernel against its plain version, mesh rays of the
    # smoke camera at 2x (pixel centres)
    f32 = dict(dtype=torch.float32, device=dev)
    tri_s = tri_ops.tiled_raycast_inputs(renderer._mesh_arrays, xf,
                                         renderer.view_projection_mat,
                                         W * f, H * f)["tri_scalars"]
    cam = torch.as_tensor(renderer.view_projection_mat, **f32)
    px = (torch.arange(W * f, **f32) + 0.5) / (W * f) * 2.0 - 1.0
    py = (torch.arange(H * f, **f32) + 0.5) / (H * f) * 2.0 - 1.0
    ndc = torch.stack([px[None].expand(H * f, W * f),
                       py[:, None].expand(H * f, W * f),
                       torch.ones((H * f, W * f), **f32)], dim=-1)
    d_all = ndc @ cam[:, :3].T
    d_all = (d_all / torch.linalg.vector_norm(d_all, dim=-1, keepdim=True))
    d_sub = d_all[::8].reshape(-1, 3).contiguous()
    d_all = d_all.reshape(-1, 3).contiguous()
    o_all = cam[:, 3].expand(d_all.shape).contiguous()
    o_sub = o_all[:d_sub.shape[0]]
    kt, ki, ku, kv = mesh_cuda.raycast(tri_s, o_sub, d_sub)
    torch.cuda.synchronize()
    pt, pi, pu, pv = mesh_cuda.raycast_reference(tri_s, o_sub, d_sub)
    torch.cuda.synchronize()
    hit_k, hit_p = ki >= 0, pi >= 0
    shared = hit_k & hit_p
    mask_diff2 = int((hit_k != hit_p).sum())
    id_diff2 = int((ki != pi).sum())
    max_dt2 = float((kt[shared] - pt[shared]).abs().max()) if shared.any() else 0.0
    max_duv2 = float(torch.maximum((ku - pu).abs(), (kv - pv).abs()).max())
    k2_ms = cuda_ms(lambda: mesh_cuda.raycast(tri_s, o_all, d_all), 5)
    p2_ms = cuda_ms(lambda: mesh_cuda.raycast_reference(tri_s, o_sub, d_sub), 1)
    print(f"untiled ray-cast: {tri_s.shape[0]} triangles; compared on every 8th "
          f"row, {d_sub.shape[0]} rays, {int(hit_p.sum())} hits: hit-mask "
          f"mismatches {mask_diff2}, id mismatches {id_diff2}, max |dt| "
          f"{max_dt2:.3g}, max |du|,|dv| {max_duv2:.3g}; kernel {k2_ms:.3f} ms "
          f"on all {d_all.shape[0]} rays, plain {p2_ms:.1f} ms on the "
          f"{d_sub.shape[0]} compared rays")
    if not (mask_diff2 == 0 and id_diff2 == 0 and max_dt2 <= KERNEL_T_TOL
            and int(hit_p.sum()) > 0):
        raise AssertionError("untiled kernel disagrees with its plain version")
    del kt, ki, ku, kv, pt, pi, pu, pv, d_all, o_all, d_sub, o_sub, ndc

    # 8: the flash frame through the renderer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frenderer, fnerf = make_renderer(dev, W, H, glasses, bake=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fnerf.bake(512, feat_resolution=256)     # the same bake, timed alone
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    sig_b = fnerf._baked_sigma.numel() * fnerf._baked_sigma.element_size()
    feat_b = fnerf._baked_feat.numel() * fnerf._baked_feat.element_size()
    print(f"load_nerf(bake=True): {load_s:.2f} s (load + bake + fidelity "
          f"probe); bake alone {bake_s:.2f} s; sigma grid "
          f"{tuple(fnerf._baked_sigma.shape)} {sig_b / 2**20:.0f} MiB, "
          f"features {tuple(fnerf._baked_feat.shape)} {feat_b / 2**20:.0f} "
          f"MiB; fidelity probe {fnerf.bake_fidelity}")
    if fnerf.bake_fidelity is None or fnerf.bake_fidelity[1] != "ok":
        raise AssertionError(f"bake fidelity probe: {fnerf.bake_fidelity}")
    torch.cuda.reset_peak_memory_stats()
    mesh_cuda.launches = 0
    mesh_cuda.raycast_launches = 0
    frenderer.frame()
    torch.cuda.synchronize()
    fwarm_ms = frenderer.last_frame_ms
    t0 = time.perf_counter()
    fepochs = []
    for _ in range(3):
        frenderer.frame()
        fepochs.append(fnerf.last_march_epochs)
    torch.cuda.synchronize()
    flash_ms = (time.perf_counter() - t0) * 1000.0 / 3
    flash_launches = mesh_cuda.launches
    fpeak = torch.cuda.max_memory_allocated()
    print(f"flash {W}x{H}: warm-up frame {fwarm_ms:.1f} ms, {flash_ms:.1f} "
          f"ms/frame (3 frames, host clock to synchronize), march epochs "
          f"{fepochs}, peak device memory {fpeak / 2**30:.2f} GiB, path "
          f"{fnerf.last_render_path}, tiled kernel launches {flash_launches}, "
          f"untiled {mesh_cuda.raycast_launches}")
    if fnerf.last_render_path != "flash":
        raise AssertionError(f"render path {fnerf.last_render_path}")
    if flash_launches < 4:
        raise AssertionError(f"flash frames launched the tiled kernel "
                             f"{flash_launches} times")
    renderer.update_model_view_proj()
    renderer.frame()
    img_exact = renderer.display_image()
    frenderer.update_model_view_proj()
    frenderer.frame()
    img_flash = frenderer.display_image()
    fb_flash = frenderer._frame_buffer.clone()
    if not (np.isfinite(img_flash).all() and bool(torch.isfinite(fb_flash).all())):
        raise AssertionError("flash frame is not finite")
    p_flash = psnr(img_flash[..., :3], img_exact[..., :3])
    print(f"flash frame vs exact frame (same camera, sample 0): {p_flash:.2f} dB")
    if p_flash < PSNR_FLASH_VS_EXACT_DB:
        raise AssertionError("flash frame too far from the exact frame")

    # 9: the single-program hybrid frame with the same options and scene
    opts = fnerf._march_options()
    scene = fnerf._scene()
    xf2, nm2 = tri_ops.instance_transforms(frenderer._mesh_arrays,
                                           frenderer._meshes)
    pix = (0.5, 1.0 / 3.0)          # the Halton(2, 3) offset of sample 0

    def sharded(n_shards, o):
        return render_hybrid_sharded(
            fnerf.net, scene, frenderer._mesh_arrays, xf2, nm2,
            frenderer.view_projection_mat, W, H, o, n_shards=n_shards,
            light_pos=frenderer.light_pos, pix_offset=pix)

    mesh_cuda.launches = 0
    mesh_cuda.raycast_launches = 0
    sh_frame, sh_depth = sharded(1, opts)       # numpy: synchronised
    t0 = time.perf_counter()
    for _ in range(3):
        sh_frame, sh_depth = sharded(1, opts)
    sharded_ms = (time.perf_counter() - t0) * 1000.0 / 3
    untiled_launches = mesh_cuda.raycast_launches
    p_sh = psnr(sh_frame[..., :3], fb_flash[..., :3].cpu().numpy())
    print(f"single-program frame {W}x{H}, n_shards=1: {sharded_ms:.1f} ms/frame "
          f"(3 frames, to host), untiled kernel launches {untiled_launches}, "
          f"tiled {mesh_cuda.launches}; vs the renderer's flash frame "
          f"{p_sh:.2f} dB")
    if not (sh_frame.shape == (H, W, 4) and np.isfinite(sh_frame).all()):
        raise AssertionError("single-program frame is not finite")
    if untiled_launches < 4:
        raise AssertionError(f"single-program frames launched the untiled "
                             f"kernel {untiled_launches} times")
    if p_sh < PSNR_SHARDED_DB:
        raise AssertionError("single-program frame disagrees with the renderer")
    nj = dataclasses.replace(opts, jitter=False)
    f1, d1 = sharded(1, nj)
    f4, d4 = sharded(4, nj)
    shard_diff = float(max(np.abs(f4 - f1).max(), np.abs(d4 - d1).max()))
    print(f"jitter off: n_shards=4 vs n_shards=1 max |diff| {shard_diff:.3g}")
    if shard_diff > SHARD_ATOL:
        raise AssertionError("the frame depends on the shard count")
    del sh_frame, sh_depth, f1, f4, d1, d4, scene, frenderer, fnerf, fb_flash

    # 10: a small flash frame on the card against the CPU
    small = []
    for device in (dev, torch.device("cpu")):
        r, n = make_renderer(device, 160, 90, glasses, bake=True,
                             bake_resolution=128, feat_resolution=128,
                             verify_fidelity=False)
        n.march_overrides = {"compute_dtype": "float32"}
        r.frame()
        if n.last_render_path != "flash":
            raise AssertionError(f"render path {n.last_render_path}")
        small.append(r.display_image())
    p_cpu_flash = psnr(small[0][..., :3], small[1][..., :3])
    print(f"160x90 flash frame, card vs CPU (bake 128, float32 MLPs): "
          f"{p_cpu_flash:.2f} dB")
    if p_cpu_flash < PSNR_CPU_DB:
        raise AssertionError("card and CPU flash frames disagree")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "raycast_tiled", "route": "cuda",
        "source": "nerf_glasses_tpu_torch/csrc/mesh_raycast.cu",
        "replaces": "nerf_glasses_tpu/ops/mesh_pallas.py:203",
        "launches": launches, "max_abs_err": max(max_dt, max_duv),
        "ms": k_ms, "plain_ms": p_ms}, {
        "name": "raycast", "route": "cuda",
        "source": "nerf_glasses_tpu_torch/csrc/mesh_raycast.cu",
        "replaces": "nerf_glasses_tpu/ops/mesh_pallas.py:91",
        "launches": untiled_launches, "max_abs_err": max(max_dt2, max_duv2),
        "ms": k2_ms, "plain_ms": p2_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmpdir:
        main(tmpdir)

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
     package by tests/test_torch_*.py): >= 40 dB PSNR.

Prints one JSON line with the kernel's numbers, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. Exits non-zero
on any failure, when no CUDA device is present, and when the package is
not beside it.
"""

import base64
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

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "assets", "trained", "trained_head_v6.msgpack")
W, H = 1280, 720
KERNEL_T_TOL = 1e-6     # kernel and plain version agree bit for bit
                        # (-fmad=false, same operation order)
PSNR_PLAIN_DB = 50.0
PSNR_CPU_DB = 40.0


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


def make_renderer(device, width, height, glasses):
    """The trained head with the glasses placed on it, camera as the
    repository's bench places it."""
    r = NerfMeshRenderer(width, height, device=device)
    nerf = r.load_nerf(SNAPSHOT)
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

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "raycast_tiled", "route": "cuda",
        "source": "nerf_glasses_tpu_torch/csrc/mesh_raycast.cu",
        "replaces": "nerf_glasses_tpu/ops/mesh_pallas.py:203",
        "launches": launches, "max_abs_err": max(max_dt, max_duv),
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmpdir:
        main(tmpdir)

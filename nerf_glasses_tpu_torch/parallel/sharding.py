"""Data parallelism over ranks with torch.distributed.

Port of nerf_glasses_tpu/parallel/sharding.py: pure data parallelism over
the ray or pixel dimension.

- Rendering: rays (make_sharded_march, render_image_sharded) or pixel
  rows (render_hybrid_sharded) are cut into one contiguous share per
  rank; the network, the scene and the mesh are replicated, and the
  march needs no collective. Each rank writes its share into a zero
  buffer of the whole result and one all_reduce(SUM) joins the shares:
  every element is nonzero on one rank only, so the sum is exact, and
  every rank ends with the whole frame.
- Training (ShardedTrainer): each rank draws its own rays_per_batch //
  size rays; loss, gradients and aux gradients are averaged, the error
  map's rasters and the keep-set overflow counts summed
  (train/trainer.py::_train_step_body with a mesh), and every rank then
  applies the same Adam step, so the replicated state stays bitwise
  equal on every rank. The grid refresh is replicated: every rank draws
  it from a generator seeded alike, the rays from one seeded by (seed,
  rank).

Only all_reduce and broadcast are used: the gloo backend carries both for
CUDA tensors too, so two gloo ranks can share one card.

A process group comes from torchrun (make_mesh() initialises it from the
environment) or from run_on_mesh, which spawns the ranks of one machine.
There is no fallback from nccl to gloo or from the card to the CPU.

Without a mesh, render_hybrid_sharded renders its n_shards row bands one
after another in one process (n_shards=1 is the JAX package's
make_mesh(1)). Rays are generated with elementwise arithmetic rather
than a matrix product, so a ray's direction does not depend on how many
rays share its batch, and the frame does not depend on the shard count
(jitter, which uses shard-local ray ids as in the JAX package, aside).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_glasses_tpu_torch.ops import mesh_cuda
from nerf_glasses_tpu_torch.ops import triangles as tri_ops
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb
from nerf_glasses_tpu_torch.ops.raymarch import (camera_rays, flash_init,
                                                 march_frame, march_frame_impl,
                                                 march_rays,
                                                 upsample_flash_init)
from nerf_glasses_tpu_torch.train import trainer as trainer_mod

GROUP_TIMEOUT_S = 120.0


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a process group: its rank among `size`, the
    device its tensors live on and the group's backend."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    def reduce(self, tensors: List[torch.Tensor],
               mean: bool = False) -> List[torch.Tensor]:
        """Sum (or mean) of each tensor over the ranks, in one all_reduce
        of their concatenation -> new tensors; the tensors share a dtype."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        if mean:
            flat = flat / self.size
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
        return out

    def broadcast(self, tensors: List[torch.Tensor], src: int = 0):
        """Overwrite each tensor in place with rank `src`'s."""
        for t in tensors:
            dist.broadcast(t, src, group=self.group)


def make_mesh(n_devices: Optional[int] = None, backend: str = "nccl",
              device=None) -> Mesh:
    """The mesh of the initialised process group, or of the one torchrun's
    environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) describes.

    device: None or "cuda" -> cuda:LOCAL_RANK; "cuda:i" -> that card for
    every rank; "cpu" -> the CPU, with backend "gloo" only. nccl needs a
    card per rank: with fewer visible than ranks this raises. n_devices,
    if given, must equal the group's size."""
    if backend == "nccl":
        want = (dist.get_world_size() if dist.is_initialized()
                else int(os.environ.get("WORLD_SIZE", "1")))
        if torch.cuda.device_count() < want:
            raise RuntimeError(
                f"nccl needs a GPU per rank: {want} ranks, "
                f"{torch.cuda.device_count()} GPUs visible")
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no process group: start the ranks with "
                               "torchrun or parallel.sharding.run_on_mesh")
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    got = dist.get_backend()
    if got != backend:
        raise ValueError(f"the process group runs {got}, not {backend}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) in a group of {size}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", rank)))
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"{device} is not visible "
                               f"({torch.cuda.device_count()} GPUs)")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"nccl cannot run on {device}")
    return Mesh(dist.group.WORLD, rank, size, device, backend)


def _rank_main(fn, rank, n, backend, device, store, timeout, results,
               args):
    """One spawned rank of run_on_mesh: join the group, run fn(mesh,
    *args), report (rank, ok, result or traceback)."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(make_mesh(n, backend, device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_on_mesh(fn, n: int, backend: str, device, *args,
                timeout: float = GROUP_TIMEOUT_S):
    """Spawn n ranks on this machine, join them in one process group
    (a FileStore in a temporary directory) and run fn(mesh, *args) on each
    -> [result of rank 0, ..., rank n-1].

    fn must be importable by its module path (spawned ranks start from a
    fresh interpreter) and return picklable values (numpy, not CUDA
    tensors). device as in make_mesh: "cuda" gives rank r cuda:r, "cpu"
    one torch thread per rank. Raises, after ending every rank, if a rank
    raised or the ranks did not all finish within `timeout` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, backend, str(device), store,
                                   timeout, results, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        done, errors = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if (p.exitcode not in (None, 0) and r not in done
                                and r not in errors):
                            errors[r] = f"exited with code {p.exitcode}"
                    continue
                (done if ok else errors)[rank] = val
        finally:
            for p in procs:
                p.join(timeout=5.0 if not errors and len(done) == n else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("run_on_mesh: " + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    if len(done) < n:
        raise TimeoutError(f"run_on_mesh: ranks {sorted(set(range(n)) - set(done))} "
                           f"did not finish within {timeout} s")
    return [done[r] for r in range(n)]


# ---------------------------------------------------------------------------
# Sharded rendering
# ---------------------------------------------------------------------------

def _share(mesh: Mesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} rays do not split into {mesh.size} equal "
                         f"shares")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def make_sharded_march(mesh: Mesh, opts):
    """-> fn(net, scene, o, d, surface_rgba, t_surface) -> (rgba (N, 4),
    depth (N,)) on every rank. The inputs are whole and replicated; each
    rank marches its contiguous share of the N rays, with march_frame
    when the share is a multiple of opts.chunk and march_rays otherwise,
    and one all_reduce joins the shares."""

    @torch.no_grad()
    def fn(net, scene, o, d, surface_rgba, t_surface):
        n = o.shape[0]
        mine = _share(mesh, n)
        march = march_frame if (n // mesh.size) % opts.chunk == 0 \
            else march_rays
        out = march(net, scene, o[mine], d[mine], surface_rgba[mine],
                    t_surface[mine], opts)
        rgba = torch.zeros((n, 4), device=o.device)
        depth = torch.zeros((n,), device=o.device)
        rgba[mine] = out["rgba"]
        depth[mine] = out["depth"]
        rgba, depth = mesh.reduce([rgba, depth])
        return rgba, depth

    return fn


def render_image_sharded(net, scene, camera, width: int, height: int, opts,
                         mesh: Mesh, surface_rgba=None, t_surface=None):
    """Full frame through a packed 3x4 camera with its rays sharded over
    the mesh -> (rgba (H, W, 4), depth (H, W)) numpy on every rank. The
    rays are padded to a multiple of mesh.size with copies of the last
    one, and the padding is cut off the result."""
    o, d = camera_rays(camera, width, height)
    npix = o.shape[0]
    pad = (-npix) % mesh.size
    if surface_rgba is None:
        surface_rgba = np.zeros((npix, 4), np.float32)
        t_surface = np.zeros((npix,), np.float32)
    surface_rgba = np.asarray(surface_rgba, np.float32).reshape(npix, 4)
    t_surface = np.asarray(t_surface, np.float32).reshape(npix)
    if pad:
        o = np.concatenate([o, np.repeat(o[-1:], pad, 0)])
        d = np.concatenate([d, np.repeat(d[-1:], pad, 0)])
        surface_rgba = np.concatenate(
            [surface_rgba, np.zeros((pad, 4), np.float32)])
        t_surface = np.concatenate([t_surface, np.zeros(pad, np.float32)])
    dev = scene["occ"].device
    rgba, depth = make_sharded_march(mesh, opts)(
        net, scene, *(torch.as_tensor(a, device=dev)
                      for a in (o, d, surface_rgba, t_surface)))
    return (rgba[:npix].reshape(height, width, 4).cpu().numpy(),
            depth[:npix].reshape(height, width).cpu().numpy())


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
                              supersample: int = 2,
                              mesh: Optional[Mesh] = None):
    """-> fn(net, scene, xforms, nrm_mats, cam, light, pix_offset) ->
    (frame (H, W, 4) linear premultiplied, depth (H, W)) tensors on the
    scene's device, the hybrid frame rendered in n_shards row bands.

    Per band: the mesh pass for its rows at `supersample` resolution with
    the untiled ray-cast kernel (mesh_cuda.raycast), shade_hits_compacted
    and the block reduce into surface payloads, then the compacting march
    on its rays. The flash coarse init is computed over the whole frame
    (on every rank), so its min filter sees no band seams. Without a
    mesh one process renders every band in turn; with one, n_shards is
    mesh.size and rank r renders band r, and an all_reduce joins them."""
    if mesh is not None and n_shards != mesh.size:
        raise ValueError(f"n_shards {n_shards} on a mesh of {mesh.size}")
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
                                  t_floor=t_floor, alive_mask=alive,
                                  linear_colors=False)
        return (out["rgba"].reshape(rows, width, 4),
                out["depth"].reshape(rows, width))

    def full(net, scene, xforms, nrm_mats, cam, light, pix_offset):
        dev = scene["occ"].device
        f32 = dict(dtype=torch.float32, device=dev)
        cam = torch.as_tensor(np.asarray(cam, np.float32), **f32)
        xforms = torch.as_tensor(np.asarray(xforms, np.float32), **f32)
        nrm_mats = torch.as_tensor(np.asarray(nrm_mats, np.float32), **f32)
        light = torch.as_tensor(np.asarray(light, np.float32), **f32)
        tri_world = torch.cat(tri_ops.world_triangles(tri_mesh, xforms),
                              dim=1).contiguous()
        t_up = a_up = None
        if flash:
            tmin, alive_img = flash_init(scene, cam, width, height, opts)
            t_up, a_up = upsample_flash_init(tmin, alive_img, width, height,
                                             opts.lowres_factor)
        bands = range(n_shards) if mesh is None else (mesh.rank,)
        frames, depths = [], []
        for s in bands:
            band = slice(s * rows * width, (s + 1) * rows * width)
            fr, dp = local(net, scene, tri_world, nrm_mats, cam, light,
                           pix_offset, s * rows,
                           None if t_up is None else t_up[band],
                           None if a_up is None else a_up[band])
            frames.append(fr)
            depths.append(dp)
        if mesh is None:
            return torch.cat(frames), torch.cat(depths)
        frame = torch.zeros((height, width, 4), **f32)
        depth = torch.zeros((height, width), **f32)
        mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        frame[mine], depth[mine] = frames[0], depths[0]
        frame, depth = mesh.reduce([frame, depth])
        return frame, depth

    return full


@torch.no_grad()
def render_hybrid_sharded(net, scene, tri_mesh, xforms, nrm_mats, camera,
                          width: int, height: int, opts,
                          mesh: Optional[Mesh] = None, n_shards: int = 1,
                          light_pos=(1.0, 1.0, 1.0), pix_offset=(0.5, 0.5)):
    """Full hybrid frame (mesh pass + flash init + march) in row bands ->
    (frame (H, W, 4) linear premultiplied, depth (H, W)) numpy: with a
    mesh, rank r renders band r of mesh.size and every rank returns the
    whole frame; without one, n_shards bands in turn. Builds no autograd
    graph, also for a network that trains."""
    if mesh is not None:
        if n_shards != 1:
            raise ValueError("pass a mesh or n_shards, not both")
        n_shards = mesh.size
    fn = make_hybrid_frame_sharded(n_shards, tri_mesh, opts, width, height,
                                   mesh=mesh)
    frame, depth = fn(net, scene, xforms, nrm_mats, camera, light_pos,
                      pix_offset)
    return frame.cpu().numpy(), depth.cpu().numpy()


# ---------------------------------------------------------------------------
# Sharded training
# ---------------------------------------------------------------------------

def _local_opts(mesh: Mesh, opts):
    local = opts.rays_per_batch // mesh.size
    if local * mesh.size != opts.rays_per_batch:
        raise ValueError(f"rays_per_batch {opts.rays_per_batch} does not "
                         f"split over {mesh.size} ranks")
    return dataclasses.replace(opts, rays_per_batch=local)


def _make_local_step(mesh: Mesh, opts):
    """One data-parallel step -> fn(state, data, draws) -> (state, loss):
    this rank's draws are of rays_per_batch // size rays; loss and
    gradients averaged, the error map's rasters summed over the ranks
    (trainer._train_step_body with the mesh)."""
    local_opts = _local_opts(mesh, opts)

    def local_step(state, data, draws):
        return trainer_mod.train_step(state, data, local_opts, draws, mesh)

    return local_step


def make_sharded_train_step(mesh: Mesh, opts):
    """-> fn(state, data, draws_fn) -> (state, loss): one data-parallel
    step on draws_fn("step", per-rank options)."""
    local_step = _make_local_step(mesh, opts)
    local_opts = _local_opts(mesh, opts)

    def step(state, data, draws_fn):
        return local_step(state, data, draws_fn("step", local_opts))

    return step


def make_sharded_train_chunk(mesh: Mesh, opts):
    """-> fn(state, data, n_steps, update_grid, rebuild_occ, draws_fn) ->
    (state, losses (n_steps,)): the replicated grid refresh first when
    `update_grid`, then n_steps data-parallel steps; the losses stay on
    the device (trainer.train_chunk with the mesh)."""
    local_opts = _local_opts(mesh, opts)

    def chunk(state, data, n_steps, update_grid, rebuild_occ, draws_fn):
        return trainer_mod.train_chunk(state, data, local_opts, n_steps,
                                       update_grid, rebuild_occ, draws_fn,
                                       mesh)

    return chunk


def state_tensors(state):
    """(name, tensor) of every tensor of a train state that ranks
    replicate: the network's parameters, Adam moments, aux models and
    their moments, density grid, occupancy, error map, loss EMA and the
    overflow counters."""
    out = [(f"net.{k}", p) for k, p in state["net"].named_parameters()]

    def walk(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{prefix}.{k}", v[k])
        elif isinstance(v, torch.Tensor):
            out.append((prefix, v))

    for k in sorted(state):
        if k != "net":
            walk(k, state[k])
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def replica_mismatches(mesh: Mesh, state) -> List[str]:
    """Names of the replicated tensors of `state` that differ, bit for
    bit, from rank 0's (each compared with rank 0's, broadcast)."""
    bad = []
    for name, t in state_tensors(state):
        ref = t.detach().clone()
        mesh.broadcast([ref])
        if not torch.equal(_bits(ref), _bits(t)):
            bad.append(name)
    return bad


class ShardedTrainer(trainer_mod.Trainer):
    """Trainer with the ray batch data-parallel over a mesh's ranks.

    Every rank builds the same state from the same seed; rank 0's is then
    broadcast, so that the replicas start equal. Steps run in
    grid-cadence chunks (make_sharded_train_chunk): the grid refresh and
    up to grid_update_interval data-parallel steps, the losses fetched
    once at the end of train()."""

    def __init__(self, dataset, opts=None, seed: int = 1337,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        super().__init__(dataset, opts, seed, device=self.mesh.device)
        self.ray_gen = torch.Generator(device=self.device)
        self.ray_gen.manual_seed(int(np.random.SeedSequence(
            [seed, self.mesh.rank]).generate_state(1)[0]))
        self._step_fn = make_sharded_train_step(self.mesh, self.opts)
        self._chunk_fn = make_sharded_train_chunk(self.mesh, self.opts)
        # the warmup variants (compaction forced off while the occupancy
        # grid is dense, Trainer._chunk_opts): the same objects when the
        # options have no compaction to turn off
        warm = self._chunk_opts(0)
        if warm is not self.opts:
            self._step_fn_warmup = make_sharded_train_step(self.mesh, warm)
            self._chunk_fn_warmup = make_sharded_train_chunk(self.mesh, warm)
        else:
            self._step_fn_warmup = self._step_fn
            self._chunk_fn_warmup = self._chunk_fn
        with torch.no_grad():
            self.mesh.broadcast([t for _, t in state_tensors(self.state)])

    def _draws(self, kind: str, opts):
        """Grid draws from the generator every rank seeds alike; step draws
        from this rank's own."""
        if kind == "grid":
            return super()._draws(kind, opts)
        return trainer_mod.draw_step(self.ray_gen, self.state, self.data,
                                     opts)

    def _fns_for(self, step: int):
        """(chunk_fn, step_fn) honouring the compaction warmup gate."""
        if self._chunk_opts(step) is not self.opts:
            return self._chunk_fn_warmup, self._step_fn_warmup
        return self._chunk_fn, self._step_fn

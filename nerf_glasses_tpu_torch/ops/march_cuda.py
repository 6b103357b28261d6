"""The exact march's per-ray loops: the CUDA kernels, their wrappers and
their plain PyTorch versions, and the empty-space probes the loops call.

- `advance` walks rays through empty space to the next occupied voxel,
  the per-epoch advance pass (raymarch._advance_pass; the JAX package's
  `_advance_pass`, a fori_loop inside its one compiled march,
  nerf_glasses_tpu/ops/raymarch.py:730-764).
- `samples` generates a round's K samples, each after at most
  skip_iters probes (JAX: `_march_round`'s gen_step and skip_body,
  raymarch.py:782-812).
- `advance_samples` is the advance followed by the first round's samples
  on the advanced rays, in one launch: what an epoch of sequential
  rounds starts with (raymarch.march_frame_impl).
- `init_walk` is init_rays' bounded walk to the first occupied voxel
  (JAX: raymarch.py:518-565).
- `walk_list` is the exact epoch's walk on the frame's own arrays
  through the epoch's live-ray list (raymarch._march_lists): the advance
  and the first round's samples (or a later round's samples) of each
  listed ray, t and alive written back in place, and each valid slot's
  network input as a row (`list_buffers`).
  The five run one kernel body, nmr_march_walk's walk_kernel, in the
  form each needs.
- `composite` (nmr_march_composite) is the non-vector compositing of
  `_march_round` from the network's rows: the activations and alpha of
  each used slot, the in-march surface blend, the K-sample front-to-back
  loop and the final surface blend; the baked path, whose colour
  selection reads the blended state, runs the blend (STAGE_BLEND) and the
  rest (STAGE_SAMPLES) as two calls, with a dense alpha from its baked
  sigma and colour rows for the slots it colours. `dense_round` spreads
  a round's rows over its (K, n) slots, as the vector rounds need them.
- `composite_list` is the same compositing on the listed rays of the
  frame's arrays, in place, from the rows walk_list made and the
  network's outputs on them; it lists the rays still alive for the next
  epoch.
- `training_samples` (nmr_training_samples) is the trainer's geometry
  pass, its march_hops occupancy hops and its stratified samples placed
  by inverse CDF over the occupied length, one launch a step
  (train/trainer.py::march_training_samples; the JAX package's
  `march_training_samples`, a jax.lax.scan inside its one compiled step,
  nerf_glasses_tpu/train/trainer.py:443-513). `compare_training_samples`
  holds it to the card's plain version.
None of these was a Pallas kernel: the TPU could not gather from its
fast memory inside a kernel (docs/KERNELS.md section 2), so the JAX
package left the loops to XLA. A GPU thread runs one ray's loop and
leaves it as soon as the ray settles, where the plain version masks the
ray for the remaining iterations.

Every loop calls one empty-space probe, `_skip_probe`, whose route
`probe_route` picks from the options and the scene: the cascade-0 jump
grid, the cascade-0 clearance grid (`_dist_probe`), the per-cascade
clearance pyramid (`_dist_probe_mips` + `_ladder_jump`) or the per-voxel
DDA (`_occupied` + occupancy.advance_to_next_voxel). The kernels carry
all four as device functions (csrc/march.cu).

On a CUDA tensor a wrapper launches its kernel (built with nvcc for
sm_90a at first use, ops/cuda_build.py) or raises; on a CPU tensor it
runs its plain version (`*_reference`). There is no fallback from one to
the other. Each wrapper counts its launches in `launches[name]`.

Numerics: the kernels repeat the plain version's float32 operations one
by one (nvcc -fmad=false, no fast math; host-made float32 constants where
the plain version hands aten a Python scalar; a division by a power of
two taken as the product with its exact reciprocal, which gives the same
bits), so they give the CPU plain version's bits, and so the JAX
package's on the CPU but for its fusion and transcendental functions
(tests/test_torch_march_kernels.py). The card's plain version is the
side that differs: there aten divides by a Python scalar as a
multiplication by its reciprocal (a float32 x / 3.0 on the card is x *
float32(1 / 3), x / torch.tensor(3.0, device=x.device) a true division:
the `cuda` test test_card_divides_by_a_python_scalar_with_its_reciprocal),
so a ray whose quotient lands within an ulp of an integer under a ceil
may take one step more or less there than in the kernels and on the CPU.
`compare_with_plain` holds a kernel to the contract against the card's
plain version: rays whose alive, valid or status flags or whose t differ
number at most max(4, ceil(1e-4 x rays)), and where they differ the t
values lie at most one step (MAX_CONE_STEPSIZE) apart; composite outputs
agree to 1e-6 absolute.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.ops import cuda_build
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops.network import (apply_density_activation,
                                                apply_rgb_activation)
from nerf_glasses_tpu_torch.utils.bbox import contains_aabb, ray_intersect_aabb

_SOURCE = os.path.join(cuda_build.PKG, "csrc", "march.cu")
# -fmad=false: the kernels round every product and sum on its own, as
# aten's elementwise ops do.
NVCC_FLAGS = cuda_build.ARCH_FLAGS + ("-fmad=false",)

# The kernel-vs-plain contract (compare_with_plain).
MISMATCH_FRACTION = 1e-4
MISMATCH_MIN = 4
STEP_TOL = C.MAX_CONE_STEPSIZE
COMPOSITE_ATOL = 1e-6
# The training samples' contract against the card's plain version
# (compare_training_samples): the card's aten sums the hops in float32 in
# a parallel scan and divides by S and H as a product with the
# reciprocal, the kernel (as the CPU) in double and by true division.
TRAIN_VALID_FRACTION = 1e-3
TRAIN_ATOL = 1e-5
MAX_TRAIN_HOPS = 512        # 12 bytes a hop for each of a block's 16 rays

KERNELS = ("advance", "init_walk", "samples", "advance_samples", "composite",
           "walk_list", "composite_list", "training_samples")
# Kernel launches per wrapper (CUDA tensors only).
launches = dict.fromkeys(KERNELS, 0)

_lib = None
build_log = ""
build_seconds = 0.0

ROUTE_JUMP, ROUTE_DIST, ROUTE_DIST_MIPS, ROUTE_DDA = range(4)
WALK_ADVANCE, WALK_SAMPLES, WALK_INIT, WALK_LIST = 1, 2, 4, 8
MAX_LIST_STEPS = 64            # the list walk's slot mask (csrc/march.cu)
STAGE_BLEND, STAGE_SAMPLES = 1, 2
# ops/network.py's activations as the composite kernel takes them; the
# colour's "exponential" clamps first (apply_rgb_activation)
ACTIVATIONS = {"none": 0, "relu": 1, "logistic": 2, "exponential": 3}
ACT_EXP_CLAMPED = 4


class MarchParams(ctypes.Structure):
    """csrc/march.cu's MarchParams: the route and the float32 constants
    the plain version hands aten as Python scalars, made on the host."""
    _fields_ = [("route", ctypes.c_int), ("mode", ctypes.c_int),
                ("max_cascade", ctypes.c_int), ("min_mip", ctypes.c_int),
                ("iters", ctypes.c_int), ("skip_iters", ctypes.c_int),
                ("steps", ctypes.c_int), ("deferred", ctypes.c_int),
                ("stage", ctypes.c_int), ("density_act", ctypes.c_int),
                ("rgb_act", ctypes.c_int),
                ("cone", ctypes.c_float), ("dt_min", ctypes.c_float),
                ("dt_max", ctypes.c_float), ("t1", ctypes.c_float),
                ("t2", ctypes.c_float), ("t1_end", ctypes.c_float),
                ("t2_cap", ctypes.c_float), ("lg", ctypes.c_float),
                ("dtmip_cap", ctypes.c_float), ("tau_den", ctypes.c_float),
                ("inv_cone", ctypes.c_float), ("inv_tau_den", ctypes.c_float),
                ("sat_alpha", ctypes.c_float),
                ("grid_numel", ctypes.c_longlong)]


_WALK_TENSORS = ("o", "d", "t", "t_start", "t_surf", "surf_a", "alive",
                 "grid", "box_lo", "box_hi", "local", "t_out", "alive_out",
                 "pos_k", "dt_k", "valid_k", "ts_k", "t_end", "exited",
                 "stopped", "ids", "n_list", "train_min", "train_max",
                 "row_pos01", "row_dir01", "row_ts", "row_dt", "row_first",
                 "row_count", "slot_mask")


class WalkArgs(ctypes.Structure):
    """csrc/march.cu's WalkArgs: the walk's tensors' device pointers (None
    for what a form does not read or write) and the list form's row
    capacity."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _WALK_TENSORS]
                + [("row_cap", ctypes.c_longlong)])


_COMPOSITE_IN = ("rgba", "depth", "max_weight", "wn", "surf_a", "t", "alive",
                 "surf", "t_surf", "t_end", "exited", "surf_stopped", "valid",
                 "color", "ts", "dt", "alpha", "sigma", "rgb", "slots", "rows")
_COMPOSITE_OUT = ("rgba", "depth", "max_weight", "wn", "surf_a", "alive")
_COMPOSITE_LIST = ("ids", "row_first", "slot_mask", "row_ts", "row_dt",
                   "t_out", "next_ids", "next_count")


class TrainArgs(ctypes.Structure):
    """csrc/march.cu's TrainArgs: the training march's tensors' device
    pointers."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "o", "d", "u", "occ", "aabb_min", "aabb_max", "t", "dt", "valid")]


class CompositeArgs(ctypes.Structure):
    """csrc/march.cu's CompositeArgs: the composite's tensors' device
    pointers (None for what a stage or form does not read), the density
    rows' stride and the number of rows; the list form's list, first rows
    and slot bits, rows' t and dt, frame t and next list with its
    capacity."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _COMPOSITE_IN]
                + [("sigma_stride", ctypes.c_longlong), ("m", ctypes.c_longlong)]
                + [(k + "_out", ctypes.c_void_p) for k in _COMPOSITE_OUT]
                + [(k, ctypes.c_void_p) for k in _COMPOSITE_LIST]
                + [("next_cap", ctypes.c_longlong)])


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    lib, build_log, build_seconds = cuda_build.build_library(_SOURCE,
                                                             NVCC_FLAGS)
    p = ctypes.c_void_p
    i = ctypes.c_int
    # each takes the parameters, the ray count, one pointer to its
    # tensors' pointers (a WalkArgs, a CompositeArgs) and the stream
    _lib = cuda_build.declare(lib, [
        (name, [p, i, p, p], i)
        for name in ("nmr_march_walk", "nmr_march_composite",
                     "nmr_training_samples")])
    return _lib


# ---------------------------------------------------------------------------
# The probes (plain versions of the kernels' device functions)
# ---------------------------------------------------------------------------

def _contains_local(pos, scene):
    return contains_aabb(pos @ scene["local"].T, scene["render_min"],
                         scene["render_max"])


def _ray_exit_t(o, d, scene):
    """Render-aabb exit distance per ray; -inf for rays that miss it."""
    _, tmax = ray_intersect_aabb(o @ scene["local"].T, d @ scene["local"].T,
                                 scene["render_min"], scene["render_max"])
    return torch.where(tmax >= 3e38, -torch.inf, tmax)


def _occupied(scene, pos, dt, opts):
    if opts.config.max_cascade == 0 and opts.min_mip == 0:
        mip = torch.zeros(pos.shape[:-1], dtype=torch.int32,
                          device=pos.device)
    else:
        mip = torch.clamp(
            occ_ops.mip_from_dt(dt, pos, opts.config.max_cascade),
            min=opts.min_mip)
    return occ_ops.occupied_at(scene["occ"], pos, mip), mip


def _dist_probe(scene, pos, t, d):
    """One-gather clearance probe on cascade 0 -> (occupied, t_advanced).

    scene["dist"] holds the Chebyshev distance k in voxels to the nearest
    occupied voxel; the ray hops to where it leaves the empty (2k-1)^3
    box around its voxel (k == 1 is the one-voxel DDA step, k == 0 is
    occupied). Constant dt only: the advance lands on the same
    MIN_CONE_STEPSIZE lattice as the DDA probe."""
    fdt = C.MIN_CONE_STEPSIZE
    G = C.NERF_GRIDSIZE
    vox = 1.0 / G
    k = occ_ops.dist_at(scene["dist"], pos).float()    # uint8 -> float
    vi = torch.nan_to_num(pos * G).trunc().clamp(0.0, G - 1.0)
    kk = k[..., None]
    bound = torch.where(d > 0.0, (vi + kk) * vox, (vi - (kk - 1.0)) * vox)
    dir_zero = d == 0.0
    tt = torch.where(dir_zero, 1e9,
                     (bound - pos) / torch.where(dir_zero, 1.0, d))
    delta = torch.clamp(torch.amin(tt, dim=-1), min=0.0)
    return k == 0.0, t + torch.clamp(torch.ceil(delta / fdt), min=1.0) * fdt


def _dist_probe_mips(scene, pos, t, d, dt, opts):
    """Cascade-aware clearance probe -> (occupied, t_advanced).

    scene["dist_mips"] holds, per cascade, the distance in that cascade's
    voxels to its nearest occupied voxel. One uint8 gather at the
    sample's governing mip gives the occupancy bit (k == 0, the same bit
    as occupied_at) and a hop to the edge of the empty (2k-1)^3 ball.
    An empty cascade-c ball holds no finer content but may hold coarser
    content, so the hop is cut where the governing mip could rise:
    - delta_cube: where the ray leaves the side-2^mip cube (mip_from_pos
      grows past it), plus one voxel;
    - delta_dtmip: where the cone step crosses its next power of two
      (mip_from_dt grows there); none at the MAX_CONE_STEPSIZE clamp or
      with constant dt.
    Samples stay occupancy-gated at their own positions, so the step of
    at least one dt may overshoot the cuts as the DDA probe's does."""
    G = C.NERF_GRIDSIZE
    pyr = scene["dist_mips"]
    mip = torch.clamp(occ_ops.mip_from_dt(dt, pos, opts.config.max_cascade),
                      min=opts.min_mip)
    s = torch.exp2(mip.float())[..., None]
    q = (pos - 0.5) / s + 0.5                       # cascade-local [0, 1]
    cell = torch.nan_to_num(q * G).trunc().clamp(0.0, G - 1.0)
    ci = cell.long()
    flat = ((mip.long() * G + ci[..., 2]) * G + ci[..., 1]) * G + ci[..., 0]
    k = pyr.reshape(-1)[flat.clamp(0, pyr.numel() - 1)].float()

    vox = 1.0 / G
    kk = k[..., None]
    bound = torch.where(d > 0.0, (cell + kk) * vox, (cell - (kk - 1.0)) * vox)
    dir_zero = d == 0.0
    safe_d = torch.where(dir_zero, 1.0, d)
    tt = torch.where(dir_zero, 1e9,
                     (bound - q) / (safe_d / s))
    delta_ball = torch.clamp(torch.amin(tt, dim=-1), min=0.0)

    cb = torch.where(d > 0.0, 0.5 + 0.5 * s, 0.5 - 0.5 * s)
    tc = torch.where(dir_zero, 1e9, (cb - pos) / safe_d)
    delta = torch.minimum(delta_ball,
                          torch.clamp(torch.amin(tc, dim=-1), min=0.0) + vox)

    if opts.cone_angle > 0.0:
        _, e = torch.frexp(dt * (2 * G))
        tau_next = (torch.exp2(torch.clamp(e, min=0).float())
                    / (2 * G * opts.cone_angle))
        tau = dt / opts.cone_angle      # t - t_start while dt is unclamped
        delta_dtmip = torch.where(
            dt >= C.MAX_CONE_STEPSIZE - 1e-9, 1e9,
            torch.clamp(tau_next - tau, min=0.0) + dt)
        delta = torch.minimum(delta, delta_dtmip)
    return k == 0.0, _ladder_jump(t, t + delta, opts.cone_angle)


def _ladder_constants(cone_angle: float):
    """_ladder_jump's float32 constants, made on the host with numpy ->
    (dmin, dmax, t1, t2, t1 + dmin, t2 (1 + cone), lg)."""
    f32 = np.float32
    dmin, dmax, cone = (f32(C.MIN_CONE_STEPSIZE), f32(C.MAX_CONE_STEPSIZE),
                        f32(cone_angle))
    t1, t2 = f32(dmin / cone), f32(dmax / cone)
    return (dmin, dmax, t1, t2, f32(t1 + dmin), f32(t2 * f32(1.0 + cone_angle)),
            f32(np.log1p(cone_angle)))


def _ladder_jump(t, target, cone_angle: float):
    """Smallest point >= target on the stepping ladder t_{i+1} = t_i +
    calc_dt(t_i) continued from t, at least one step on.

    The exact march walks this ladder through empty space one voxel hop
    at a time (occupancy.advance_to_next_voxel); landing a clearance hop
    on the ladder keeps its sample positions where that walk puts them.
    Closed form per regime: uniform MIN_CONE_STEPSIZE below t1 = MIN /
    cone, geometric x (1 + cone) from t1 to t2 = MAX / cone, uniform MAX
    above. float32 log and exp drift ~1e-6 relative from the iterated
    sum, and one unit of roundoff under the ceil moves a ray one rung."""
    dmin = np.float32(C.MIN_CONE_STEPSIZE)
    if cone_angle == 0.0:
        n = torch.clamp(torch.ceil((target - t) / float(dmin)), min=1.0)
        return t + n * float(dmin)
    _, dmax, t1, t2, t1_end, t2_cap, lg = map(float,
                                             _ladder_constants(cone_angle))
    # regime A (t < t1): uniform dmin to min(target, first rung >= t1)
    tA_end = torch.clamp(target, max=t1_end)
    nA = torch.ceil(torch.clamp(tA_end - t, min=0.0) / float(dmin))
    out = torch.where(t < t1, t + nA * float(dmin), t)
    # regime B (t1 <= out < t2, target beyond): geometric
    need_b = (out < target) & (out >= t1) & (out < t2)
    ratio = torch.clamp(
        torch.clamp(target, max=t2_cap) / torch.clamp(out, min=1e-30),
        min=1.0)
    nB = torch.ceil(torch.log(ratio) / lg)
    out = torch.where(need_b, out * torch.exp(nB * lg), out)
    # regime C (out >= t2, target beyond): uniform dmax
    need_c = (out < target) & (out >= t2)
    nC = torch.ceil((target - out) / dmax)
    out = torch.where(need_c, out + nC * dmax, out)
    return torch.maximum(out, t + occ_ops.calc_dt(t, cone_angle))


def probe_route(scene, opts):
    """The empty-space probe's route and grid -> (ROUTE_*, uint8 grid).
    The clearance grid serves a single cascade with constant dt and no
    min_mip, the pyramid several cascades (both with dist_advance); else
    single-cascade scenes read the jump grid, which gives the occupancy
    bit and the coarsest empty block in one gather, and multi-cascade
    scenes (or a min_mip) probe their mip and step one voxel of it."""
    cfg = opts.config
    if (opts.dist_advance and opts.cone_angle == 0.0 and cfg.max_cascade == 0
            and opts.min_mip == 0 and "dist" in scene):
        return ROUTE_DIST, scene["dist"]
    if opts.dist_advance and cfg.max_cascade > 0 and "dist_mips" in scene:
        return ROUTE_DIST_MIPS, scene["dist_mips"]
    if cfg.max_cascade == 0 and opts.min_mip == 0:
        return ROUTE_JUMP, scene["skip"]
    return ROUTE_DDA, scene["occ"]


def _skip_probe(scene, pos, t, d, idir, dt, opts):
    """One-gather empty-space probe -> (occupied, t_advanced), on the
    route probe_route picks."""
    route, grid = probe_route(scene, opts)
    if route == ROUTE_DIST:
        return _dist_probe(scene, pos, t, d)
    if route == ROUTE_DIST_MIPS:
        return _dist_probe_mips(scene, pos, t, d, dt, opts)
    if route == ROUTE_JUMP:
        lv = occ_ops.skip_level_at(grid, pos)
        occ = lv == 255
        res = C.NERF_GRIDSIZE * torch.exp2(-torch.clamp(lv, max=4).float())
    else:
        occ, mip = _occupied(scene, pos, dt, opts)
        res = C.NERF_GRIDSIZE * torch.exp2(-mip.float())
    adv = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, d, idir, res)
    return occ, adv


# ---------------------------------------------------------------------------
# The plain versions of the loops
# ---------------------------------------------------------------------------

def init_walk_reference(o, d, t, t_surface, alive, scene, opts,
                        probes=None):
    """init_rays' bounded walk (opts.init_skip_iters probes) -> (t,
    alive): rays stop at their first occupied voxel, park at t_surface
    once past it, and leave the render aabb (a ray with a surface parks
    at it, one without dies). probes: as advance_reference's."""
    has_surface = t_surface > 0.0
    idir = 1.0 / d
    settled = ~alive
    for _ in range(opts.init_skip_iters):
        pos = o + d * t[:, None]
        at_surface = has_surface & (t > t_surface)
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        newly_surface = ~settled & alive & at_surface
        newly_exit = ~settled & alive & ~at_surface & ~inside
        newly_hit = ~settled & alive & ~at_surface & inside & occ
        if probes is not None:
            probes += ~settled & alive & ~at_surface & inside
        t = torch.where(newly_surface | (newly_exit & has_surface),
                        t_surface, t)
        alive = alive & ~(newly_exit & ~has_surface)
        settled = settled | newly_surface | newly_exit | newly_hit | ~alive
        t = torch.where(~settled & alive, adv, t)
    return t, alive


def advance_reference(st, scene, opts, iters: int, probes=None):
    """The advance pass on a state dict -> (t, alive): iters probes; rays
    exiting the aabb with no pending surface die, rays with a pending
    surface are parked at t_surface. probes: an (n,) int32 tensor or
    None; each ray's probe count (the probes its kernel thread makes) is
    added to it."""
    o, d = st["o"], st["d"]
    idir = 1.0 / d
    t_surface = st["t_surf"]
    surf_live = (t_surface > 0.0) & (st["surf_a"] > 0.0)
    t_exit = _ray_exit_t(o, d, scene)
    t, alive = st["t"], st["alive"]
    settled = ~alive
    for _ in range(iters):
        active = ~settled & alive
        pos = o + d * t[:, None]
        surf_pending = surf_live & (t >= t_surface)
        inside = t <= t_exit
        dt = occ_ops.calc_dt(t - st["t_start"], opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        newly_park = active & (surf_pending | (~inside & surf_live))
        newly_exit = active & ~surf_pending & ~inside & ~surf_live
        newly_hit = active & ~surf_pending & inside & occ
        if probes is not None:
            probes += active & ~surf_pending & inside
        t = torch.where(newly_park, t_surface, t)
        alive = alive & ~newly_exit
        settled = settled | newly_park | newly_hit | ~alive
        t = torch.where(~settled & alive, adv, t)
    return t, alive


def samples_reference(st, scene, opts, probes=None):
    """K sequential steps of <= skip_iters probes -> samples (pos (K, n,
    3), dt (K, n), valid (K, n), t (K, n)), t_end, exited,
    surf_stopped. probes: as advance_reference's."""
    K = opts.steps_per_round
    o, d = st["o"], st["d"]
    idir = 1.0 / d
    t_surface, t_start = st["t_surf"], st["t_start"]
    has_surface = t_surface > 0.0
    alive, surf_a = st["alive"], st["surf_a"]
    t, gen_alive = st["t"], alive
    exited = torch.zeros_like(alive)
    surf_stopped = torch.zeros_like(alive)
    pos_k, dt_k, valid_k, ts_k = [], [], [], []
    for _ in range(K):
        status = torch.where(gen_alive, 0, -1)
        for _ in range(opts.skip_iters):
            active = status == 0
            pos = o + d * t[:, None]
            surf_stop = has_surface & (t > t_surface) & (surf_a >= 1.0)
            inside = _contains_local(pos, scene)
            dt = occ_ops.calc_dt(t - t_start, opts.cone_angle)
            occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
            new_status = torch.where(surf_stop, 3, torch.where(
                ~inside, 2, torch.where(occ, 1, 0)))
            if probes is not None:
                probes += active & ~surf_stop & inside
            status = torch.where(active, new_status, status)
            t = torch.where(active & (status == 0), adv, t)
        found = status == 1
        pos_k.append(o + d * t[:, None])
        dt = occ_ops.calc_dt(t - t_start, opts.cone_angle)
        dt_k.append(dt)
        valid_k.append(found)
        ts_k.append(t)
        exited |= status == 2
        surf_stopped |= status == 3
        t = torch.where(found, t + dt, torch.where(status == 3, t_surface, t))
        gen_alive = gen_alive & (found | (status == 0))
    samples = (torch.stack(pos_k), torch.stack(dt_k), torch.stack(valid_k),
               torch.stack(ts_k))
    return samples, t, exited & alive, surf_stopped & alive


def advance_samples_reference(st, scene, opts, iters: int):
    """The advance pass, then the first round's samples on the advanced
    rays -> ((t, alive), samples_reference's outputs)."""
    t, alive = advance_reference(st, scene, opts, iters)
    return (t, alive), samples_reference({**st, "t": t, "alive": alive},
                                         scene, opts)


def surface_blend_reference(st, rnd, opts):
    """The in-march surface blend, once before the round's samples, for
    rays whose payload-t has crossed t_surface (testbed.cu:843-857) ->
    {"rgba", "wn", "surf_a", "alive"}: the state with the blend, alive
    the rays still compositing."""
    rgba, surf_a = st["rgba"], st["surf_a"]
    t_surface = st["t_surf"]
    exited, surf_stopped = rnd["exited"], rnd["surf_stopped"]
    comp_alive = st["alive"]
    t_payload = torch.where(exited, st["t"],
                            torch.where(surf_stopped, t_surface, rnd["t_end"]))
    trigger = (comp_alive & (t_surface > 0.0) & (t_payload > t_surface)
               & (surf_a > 0.0))
    T = 1.0 - rgba[:, 3]
    blend = torch.cat([st["surf"][:, :3] * (surf_a * T)[:, None],
                       (surf_a * T)[:, None]], dim=-1)
    rgba = torch.where(trigger[:, None], rgba + blend, rgba)
    surf_a = torch.where(trigger, 0.0, surf_a)
    sat = trigger & (rgba[:, 3] > 0.99)
    inv_sat = torch.where(sat, 1.0 / torch.clamp(rgba[:, 3], min=1e-9), 1.0)
    rgba = rgba * inv_sat[:, None]
    wn = st["wn"] * inv_sat if opts.deferred_color else st["wn"]
    return {"rgba": rgba, "wn": wn, "surf_a": surf_a,
            "alive": comp_alive & ~sat}


def dense_round(rnd, opts):
    """A round's network rows spread over its (K, n) slots -> (alpha (K,
    n), rgb (K, n, 3)), 0 where a slot has no row: rnd["rgb"] (M, 3) and,
    without a dense rnd["alpha"], rnd["sigma"] (M,) are the network's
    pre-activation outputs, row j that of the flat slot rnd["slots"][j]
    (torch.nonzero of rnd["color"], by default of rnd["valid"]); alpha is
    1 - exp(-act(sigma) dt) with rnd["dt"] (K, n). The vector rounds'
    colour and composite_reference's inputs."""
    cfg = opts.config
    valid = rnd["valid"]
    K, n = valid.shape
    sel = rnd["slots"]
    rgb = torch.zeros((K, n, 3), device=valid.device)
    alpha = rnd.get("alpha")
    if alpha is None:
        alpha = torch.zeros((K, n), device=valid.device)
        if sel.numel():
            sigma = apply_density_activation(rnd["sigma"],
                                             cfg.density_activation)
            alpha.view(-1)[sel] = 1.0 - torch.exp(
                -sigma * rnd["dt"].reshape(-1)[sel])
    if sel.numel():
        rgb.view(-1, 3)[sel] = apply_rgb_activation(rnd["rgb"],
                                                    cfg.rgb_activation)
    return alpha, rgb


def composite_reference(st, rnd, opts, stage: int = STAGE_BLEND | STAGE_SAMPLES):
    """A round's non-vector compositing -> {"rgba", "depth",
    "max_weight", "wn", "surf_a", "alive"}. rnd holds the round's ends
    (t_end, exited, surf_stopped (n,)) and, for STAGE_SAMPLES, its slots
    (valid, ts (K, n)) and the network's rows as dense_round takes them
    (rgb (M, 3); sigma (M,) with dt (K, n), or a dense alpha (K, n); an
    optional color mask). Stage STAGE_BLEND is the in-march surface
    blend (surface_blend_reference); STAGE_SAMPLES the front-to-back loop
    over the K samples (composite_kernel_nerf) and the final surface
    blend of rays that ended (testbed.cu:886-897), on a state whose
    alive already says which rays composite."""
    out = {k: st[k] for k in ("rgba", "depth", "max_weight", "wn", "surf_a",
                              "alive")}
    if stage & STAGE_BLEND:
        out.update(surface_blend_reference(st, rnd, opts))
    if not stage & STAGE_SAMPLES:
        return out
    rgba, wn, comp_alive = out["rgba"], out["wn"], out["alive"]
    depth, max_w = out["depth"], out["max_weight"]
    valid = rnd["valid"] & st["alive"][None]
    (alpha_k, rgb_s), ts = dense_round(rnd, opts), rnd["ts"]
    for k in range(alpha_k.shape[0]):
        use = comp_alive & valid[k]
        w = torch.where(use, alpha_k[k] * (1.0 - rgba[:, 3]), 0.0)
        rgba = rgba + torch.cat([rgb_s[k] * w[:, None], w[:, None]], dim=-1)
        if opts.deferred_color:
            wn = wn + w
        done = use & (rgba[:, 3] > 1.0 - opts.min_transmittance)
        upd = w > max_w
        max_w = torch.where(upd, w, max_w)
        depth = torch.where(upd & use, ts[k], depth)
        inv = torch.where(done, 1.0 / torch.clamp(rgba[:, 3], min=1e-9), 1.0)
        rgba = rgba * inv[:, None]
        if opts.deferred_color:
            wn = wn * inv
        comp_alive = comp_alive & ~done
    terminated_early = rnd["exited"] | rnd["surf_stopped"]
    fin = comp_alive & terminated_early & (out["surf_a"] > 0.0)
    rgba = torch.where(fin[:, None],
                       rgba + st["surf"] * (1.0 - rgba[:, 3:4]), rgba)
    return {**out, "rgba": rgba, "depth": depth, "max_weight": max_w,
            "wn": wn, "alive": comp_alive & ~terminated_early}


# ---------------------------------------------------------------------------
# The list forms: the exact epoch on the frame's arrays through its
# live-ray list
# ---------------------------------------------------------------------------

def training_samples_reference(occ, o, d, u, aabb_min, aabb_max,
                               max_cascade: int, cone_angle: float,
                               hops: int):
    """Occupancy-compacted stratified training samples (no gradient).
    -> dict(t (S, B), dt (S, B), valid (S, B)); `u` (S, B) uniform.

    Pass 1 hops each ray `hops` times through the occupancy grid and
    records the occupied segments; pass 2 places S stratified samples by
    inverse CDF over the occupied length, so the budget always covers the
    ray's whole occupied depth (the JAX package's docstring has the
    failure a fixed-dt march ran into)."""
    G = C.NERF_GRIDSIZE
    B = o.shape[0]
    S = u.shape[0]
    H = hops
    idir = 1.0 / d
    tmin, tmax = ray_intersect_aabb(o, d, aabb_min, aabb_max)
    t0 = torch.clamp(tmin, min=0.0) + 1e-6
    span = torch.clamp(tmax - t0, min=0.0)
    # fine enough to resolve mip-0 voxels, coarse enough that H hops
    # cross the whole aabb while it is fully occupied
    stride = torch.clamp(span / H, min=1.0 / G)
    t = t0
    starts, segs = [], []
    for _ in range(H):
        alive = t < tmax
        pos = o + d * t[:, None]
        dt = occ_ops.calc_dt(t, cone_angle)
        mip = occ_ops.mip_from_dt(dt, pos, max_cascade)
        occp = occ_ops.occupied_at(occ, pos, mip) & alive
        res = torch.bitwise_right_shift(torch.full_like(mip, G), mip).float()
        t_skip = occ_ops.advance_to_next_voxel(t, cone_angle, pos, d, idir,
                                               res)
        seg = torch.where(occp, torch.minimum(stride, tmax - t), 0.0)
        t_next = torch.where(occp, t + seg, torch.maximum(t_skip, t + 1e-6))
        starts.append(t)
        segs.append(seg)
        t = torch.where(alive, t_next, t)
    t_start = torch.stack(starts)                     # (H, B)
    seg = torch.stack(segs)
    cum = torch.cumsum(seg, 0)                        # inclusive segment ends
    locc = cum[-1]                                    # occupied length
    dt_eff = torch.where(locc > 0, locc / S, 1.0)
    s = (torch.arange(S, device=o.device)[:, None] + u) * dt_eff   # (S, B)
    h_idx = torch.searchsorted(cum.T.contiguous(), s.T.contiguous(),
                               right=True).T
    h_idx = torch.clamp(h_idx, max=H - 1)
    cum_ex = cum - seg                                # exclusive starts
    t_s = (torch.gather(t_start, 0, h_idx)
           + (s - torch.gather(cum_ex, 0, h_idx)))
    valid = s < locc[None, :]
    return {"t": t_s, "dt": torch.where(valid, dt_eff[None].expand(S, B), 0.0),
            "valid": valid}


def training_samples(occ, o, d, u, aabb_min, aabb_max, max_cascade: int,
                     cone_angle: float, hops: int):
    """The trainer's geometry pass -> dict(t, dt (S, B) f32, valid (S, B)
    bool), as training_samples_reference: occ the uint8 occupancy grid
    (its flat index clamped), o, d (B, 3) f32, u (S, B) f32 uniform
    draws, aabb_min, aabb_max (3,) f32, 1 <= hops <= MAX_TRAIN_HOPS. On a
    CUDA tensor one launch of nmr_training_samples (none for B = 0): a
    thread a ray runs the hops, then places its S samples."""
    dev = o.device
    if dev.type not in ("cpu", "cuda") or o.dim() != 2:
        raise ValueError(f"training_samples: o must be a (B, 3) tensor on "
                         f"the CPU or a CUDA device, got {tuple(o.shape)} on "
                         f"{dev}")
    B = o.shape[0]
    if u.dim() != 2 or u.shape[0] < 1:
        raise ValueError(f"training_samples: u must be (S, {B}), got "
                         f"{tuple(u.shape)}")
    S = u.shape[0]
    args = [_arg("o", o, torch.float32, (B, 3), dev),
            _arg("d", d, torch.float32, (B, 3), dev),
            _arg("u", u, torch.float32, (S, B), dev),
            _arg("occ", occ, torch.uint8, occ.shape, dev),
            _arg("aabb_min", aabb_min, torch.float32, (3,), dev),
            _arg("aabb_max", aabb_max, torch.float32, (3,), dev)]
    if occ.numel() == 0:
        raise ValueError("training_samples: the occupancy grid is empty")
    if not 1 <= hops <= MAX_TRAIN_HOPS:
        raise ValueError(f"training_samples: {hops} hops (1-{MAX_TRAIN_HOPS})")
    if not 0 <= max_cascade < C.NERF_CASCADES or not cone_angle >= 0.0:
        raise ValueError(f"training_samples: max_cascade {max_cascade}, "
                         f"cone_angle {cone_angle}")
    if dev.type == "cpu":
        return training_samples_reference(occ, o, d, u, aabb_min, aabb_max,
                                          max_cascade, cone_angle, hops)
    out = {"t": torch.empty((S, B), dtype=torch.float32, device=dev),
           "dt": torch.empty((S, B), dtype=torch.float32, device=dev),
           "valid": torch.empty((S, B), dtype=torch.bool, device=dev)}
    if B:
        f32 = np.float32
        params = MarchParams(
            max_cascade=max_cascade, iters=hops, steps=S, cone=f32(cone_angle),
            dt_min=f32(C.MIN_CONE_STEPSIZE), dt_max=f32(C.MAX_CONE_STEPSIZE),
            grid_numel=occ.numel())
        ta = TrainArgs(*[x.data_ptr() for x in args],
                       out["t"].data_ptr(), out["dt"].data_ptr(),
                       out["valid"].data_ptr())
        _launch("training_samples", load_library().nmr_training_samples, dev,
                params, B, ctypes.addressof(ta))
    return out


def compare_training_samples(out_k, out_p) -> dict:
    """training_samples' kernel outputs against its plain version's on the
    same inputs -> counts, the worst differences and `ok`: the valid masks
    differ on at most TRAIN_VALID_FRACTION of the (S, B) slots, and where
    both are valid t and dt agree to TRAIN_ATOL."""
    vk, vp = out_k["valid"], out_p["valid"]
    slots = vp.numel()
    diff = int((vk != vp).sum())
    both = vk & vp
    err = {k: float((out_k[k] - out_p[k])[both].abs().max())
           if bool(both.any()) else 0.0 for k in ("t", "dt")}
    allowed = math.floor(TRAIN_VALID_FRACTION * slots)
    return {"slots": slots, "valid_mismatches": diff, "allowed": allowed,
            "valid": int(vp.sum()), "max_t_err": err["t"],
            "max_dt_err": err["dt"], "max_abs_err": max(err.values()),
            "ok": diff <= allowed and max(err.values()) <= TRAIN_ATOL}


def training_samples_work(o, u, hops: int) -> tuple:
    """The geometry pass's least work on these inputs -> (flops, bytes):
    12 + 2 log2(hops) flops a sample (its arclength, the binary search
    over the sums, its t); bytes: the rays, the aabb and the draws read
    once, the three outputs written once (9 bytes a sample). The hops'
    grid reads and arithmetic depend on each ray's walk and are left out,
    so this is below the pass's true least work."""
    B, S = o.shape[0], u.shape[0]
    return ((12 + 2 * math.ceil(math.log2(hops))) * S * B,
            B * 24 + S * B * (4 + 9) + 24)


def _mask_bytes(steps: int) -> int:
    return (steps + 7) // 8


def list_buffers(n: int, steps: int, device) -> dict:
    """The buffers the list forms write, sized once for a frame whose
    first list holds n rays (no later list is longer): the rows of a
    round, at most steps * n (pos01, dir01 (rows, 3) f32, the network's
    inputs; ts, dt (rows,) f32), and a list entry's first row (n,) int32,
    slot bits (ceil(steps / 8) * n,) uint8 (slots 8b..8b+7 of entry j in
    byte b * length + j; its valid slots take its rows in slot order from
    its first row), t_end (n,) f32, exited, stopped (n,) bool."""
    f32 = dict(dtype=torch.float32, device=device)
    b8 = dict(dtype=torch.bool, device=device)
    rows = steps * n
    return {"pos01": torch.empty((rows, 3), **f32),
            "dir01": torch.empty((rows, 3), **f32),
            "ts": torch.empty(rows, **f32), "dt": torch.empty(rows, **f32),
            "first": torch.empty(n, dtype=torch.int32, device=device),
            "mask": torch.empty(_mask_bytes(steps) * n, dtype=torch.uint8,
                                device=device),
            "t_end": torch.empty(n, **f32), "exited": torch.empty(n, **b8),
            "stopped": torch.empty(n, **b8)}


def list_slot_rows(rows, n: int, steps: int):
    """The row of each slot of a list of n entries from list_buffers'
    first rows and slot bits -> (steps, n) int64, -1 for a slot with no
    row."""
    nb = _mask_bytes(steps)
    mask = rows["mask"][:nb * n].reshape(nb, 1, n)
    shift = torch.arange(8, dtype=torch.uint8, device=mask.device)[:, None]
    valid = ((mask >> shift) & 1).reshape(nb * 8, n)[:steps].bool()
    below = torch.cumsum(valid, 0) - valid.long()
    return torch.where(valid, rows["first"][:n].long() + below, -1)


def _zero_count(name, count):
    """The list forms write from row (list entry) 0 on: their counters
    start at 0."""
    if int(count[0]) != 0:
        raise ValueError(f"{name} must hold 0, holds {int(count[0])}")


def walk_list_reference(frame, ids, n, scene, opts, iters, rows, count,
                        n_dev=None):
    """walk_list's plain version: the listed rays gathered into a
    compacted copy (alive True with `iters`, the frame's without),
    advance_samples_reference (samples_reference without `iters`), t and
    alive scattered back, the valid slots' rows in list order, a ray's in
    slot order (torch.nonzero), each entry's first row, slot bits and
    ends written; count (0) becomes the row count."""
    _zero_count("walk_list: count", count)
    if n_dev is not None:
        n = min(int(n_dev[0]), n)
    K = opts.steps_per_round
    idl = ids[:n].long()
    sub = {k: frame[k][idl] for k in _STATE}
    if iters is not None:
        sub["alive"] = torch.ones(n, dtype=torch.bool, device=idl.device)
        (t, alive), gen = advance_samples_reference(sub, scene, opts, iters)
        frame["t"][idl] = t
        frame["alive"][idl] = alive
    else:
        gen = samples_reference(sub, scene, opts)
    (pos, dt, valid, ts), t_end, exited, stopped = gen
    # (entry, slot) pairs of the valid slots, entry-major
    sel = torch.nonzero(valid.T.reshape(-1)).squeeze(1)
    j, k = sel // K, sel % K
    m = sel.numel()
    rows["pos01"][:m] = ((pos[k, j] - scene["train_min"])
                         / (scene["train_max"] - scene["train_min"]))
    rows["dir01"][:m] = ((sub["d"] + 1.0) * 0.5)[j]
    rows["ts"][:m] = ts[k, j]
    rows["dt"][:m] = dt[k, j]
    per = valid.sum(0)
    rows["first"][:n] = (torch.cumsum(per, 0) - per).to(torch.int32)
    nb = _mask_bytes(K)
    bits = torch.zeros((nb * 8, n), dtype=torch.uint8, device=idl.device)
    bits[:K] = valid.to(torch.uint8)
    shift = torch.arange(8, dtype=torch.uint8, device=idl.device)[:, None]
    rows["mask"][:nb * n] = (bits.reshape(nb, 8, n) << shift).sum(
        1, dtype=torch.uint8).reshape(-1)
    rows["t_end"][:n] = t_end
    rows["exited"][:n] = exited
    rows["stopped"][:n] = stopped
    count[0] = m


_LIST_STATE = ("rgba", "depth", "max_weight", "wn", "surf_a", "t", "alive",
               "surf", "t_surf")


def _rows_like(x, idx):
    """x's rows idx in a tensor of x's shape and strides."""
    out = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                              device=x.device)
    return out.copy_(x[idx])


def composite_list_reference(frame, ids, n, rows, m, rgb, sigma, opts,
                             next_ids=None, next_count=None):
    """composite_list's plain version: the listed rays gathered in
    ascending ray id, their slots' rows (list_slot_rows) as
    composite_reference takes them, composite_reference, the state
    scattered back with t = t_end, and the rays still alive written to
    next_ids in the list's order, next_count (0) their number. The rows
    go to composite_reference in ascending ray id within a slot, slot
    after slot, and in the layout the network gave them (the colour a
    column block of a wider output): aten's CPU activations round their
    vectorised body and scalar tail apart, so an element's bits may
    depend on where it lies and on its tensor's strides. With the list
    ascending the rows lie as the gathered epoch hands them to the
    composite."""
    K = opts.steps_per_round
    if next_ids is not None:
        _zero_count("composite_list: next_count", next_count)
    idl = ids[:n].long()
    order = torch.argsort(idl)
    ids_s = idl[order]
    slot_rows = list_slot_rows(rows, n, K)[:, order]
    valid = slot_rows >= 0
    sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
    r = slot_rows.reshape(-1)[sel]
    dense = {}
    for k in ("ts", "dt"):
        dense[k] = torch.zeros((K, n), device=idl.device)
        dense[k].view(-1)[sel] = rows[k][:m][r]
    st = {k: frame[k][ids_s] for k in _LIST_STATE}
    t_end = rows["t_end"][:n][order]
    rnd = {"t_end": t_end, "exited": rows["exited"][:n][order],
           "surf_stopped": rows["stopped"][:n][order], "valid": valid,
           "ts": dense["ts"], "dt": dense["dt"], "rgb": _rows_like(rgb, r),
           "sigma": _rows_like(sigma, r), "slots": sel}
    out = composite_reference(st, rnd, opts)
    frame["t"][ids_s] = t_end
    for k, v in out.items():
        frame[k][ids_s] = v
    if next_ids is not None:
        live = idl[frame["alive"][idl]]
        next_ids[:live.numel()] = live.to(torch.int32)
        next_count[0] = live.numel()


def list_walk_outputs(frame, ids, n, rows, steps):
    """walk_list's result spread over its slots, as advance_samples gives
    it on the gathered rays -> ((t, alive), ((pos01 (K, n, 3), dt, valid,
    ts (K, n)), t_end, exited, stopped)), 0 where a slot has no row: what
    compare_with_plain and the tests hold the list walk to (pos01 where
    advance_samples gives pos)."""
    idl = ids[:n].long()
    slot_rows = list_slot_rows(rows, n, steps)
    valid = slot_rows >= 0
    r = slot_rows[valid]
    dense = {"pos01": torch.zeros((steps, n, 3), device=idl.device)}
    dense["pos01"][valid] = rows["pos01"][r]
    for k in ("dt", "ts"):
        dense[k] = torch.zeros((steps, n), device=idl.device)
        dense[k][valid] = rows[k][r]
    return ((frame["t"][idl], frame["alive"][idl]),
            ((dense["pos01"], dense["dt"], valid, dense["ts"]),
             rows["t_end"][:n], rows["exited"][:n], rows["stopped"][:n]))


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _pow2_reciprocal(x) -> np.float32:
    """1 / x where x is a power of two with a normal float32 reciprocal
    (a division by x then rounds as the product with it), else 0."""
    x = np.float32(x)
    if not (np.isfinite(x) and x > 0 and np.frexp(x)[0] == 0.5):
        return np.float32(0)
    inv = np.float32(1) / x
    return inv if np.isfinite(inv) and inv >= np.finfo(np.float32).tiny \
        else np.float32(0)


def _params(scene, opts, **kw) -> MarchParams:
    """The kernels' parameters for these options: the probe route and the
    float32 constants the plain version's Python scalars become."""
    f32 = np.float32
    route, grid = probe_route(scene, opts)
    cone = opts.cone_angle
    dmin, dmax, t1, t2, t1_end, t2_cap, lg = (
        _ladder_constants(cone) if cone > 0.0
        else (f32(C.MIN_CONE_STEPSIZE), f32(C.MAX_CONE_STEPSIZE)) + (f32(0),) * 5)
    tau_den = f32(2 * C.NERF_GRIDSIZE * cone)
    return MarchParams(
        route=route, max_cascade=opts.config.max_cascade,
        min_mip=opts.min_mip, cone=f32(cone), dt_min=dmin, dt_max=dmax,
        t1=t1, t2=t2, t1_end=t1_end, t2_cap=t2_cap, lg=lg,
        dtmip_cap=f32(C.MAX_CONE_STEPSIZE - 1e-9), tau_den=tau_den,
        inv_cone=_pow2_reciprocal(cone), inv_tau_den=_pow2_reciprocal(tau_den),
        sat_alpha=f32(1.0 - opts.min_transmittance),
        grid_numel=grid.numel(), **kw), grid


def _arg(name, x, dtype, shape, device):
    """x as the kernel takes it (contiguous) or ValueError."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be a {dtype} tensor of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


_RAY_SHAPES = {"o": 3, "d": 3, "surf": 4, "rgba": 4}


def _ray_args(name, tensors, keys):
    """The per-ray tensors `keys` of `tensors`, checked against what the
    kernels take (float32, bool for alive; (n,), (n, 3) or (n, 4) on one
    device) -> (device, n, [contiguous tensors]). Raises ValueError, on
    every device, for what the kernels do not take."""
    t = tensors["t"]
    if t.device.type not in ("cpu", "cuda") or t.dim() != 1:
        raise ValueError(f"{name}: t must be a 1-d tensor on the CPU or a "
                         f"CUDA device, got {tuple(t.shape)} on {t.device}")
    n = t.shape[0]
    args = []
    for k in keys:
        width = _RAY_SHAPES.get(k)
        args.append(_arg(k, tensors[k],
                         torch.bool if k == "alive" else torch.float32,
                         (n,) if width is None else (n, width), t.device))
    return t.device, n, args


def _scene_args(scene, grid, device):
    return [_arg("probe grid", grid, torch.uint8, grid.shape, device),
            _arg("render_min", scene["render_min"], torch.float32, (3,), device),
            _arg("render_max", scene["render_max"], torch.float32, (3,), device),
            _arg("local", scene["local"], torch.float32, (3, 3), device)]


def _launch(name, fn, dev, params, n, *ptrs):
    """One kernel launch on dev's current stream, under dev: the library
    launches on the CUDA runtime's current device."""
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(params), n, *ptrs,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"march kernel {name} launch failed: "
                           f"cudaError_t {err}")
    launches[name] += 1


_STATE = ("o", "d", "t", "t_start", "t_surf", "surf_a", "alive")
_INIT_STATE = ("o", "d", "t", "t_surf", "alive")


def _walk(name, mode, dev, n, args, scene, opts, iters):
    """The walk kernel in form `mode` (WALK_ADVANCE, WALK_SAMPLES or both;
    or WALK_INIT) on the checked state `args` (_STATE's order; _INIT_STATE's
    for WALK_INIT) on the card, one launch counted under `name` ->
    {output name: tensor}: t_out, alive_out (n,) with WALK_ADVANCE or
    WALK_INIT; with WALK_SAMPLES pos_k (K, n, 3), dt_k, valid_k, ts_k (K,
    n), t_end, exited, stopped (n,)."""
    K = opts.steps_per_round
    params, grid = _params(scene, opts, mode=mode, iters=int(iters),
                           skip_iters=int(opts.skip_iters), steps=K)
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    out = {}
    if mode & (WALK_ADVANCE | WALK_INIT):
        out.update(t_out=torch.empty(n, **f32), alive_out=torch.empty(n, **b8))
    if mode & WALK_SAMPLES:
        out.update(pos_k=torch.empty((K, n, 3), **f32),
                   dt_k=torch.empty((K, n), **f32),
                   valid_k=torch.empty((K, n), **b8),
                   ts_k=torch.empty((K, n), **f32), t_end=torch.empty(n, **f32),
                   exited=torch.empty(n, **b8), stopped=torch.empty(n, **b8))
    if n:
        state = _INIT_STATE if mode == WALK_INIT else _STATE
        tensors = dict(zip(state + ("grid", "box_lo", "box_hi", "local"),
                           args + _scene_args(scene, grid, dev)))
        tensors.update(out)
        walk = WalkArgs(**{k: tensors[k].data_ptr() if k in tensors else None
                           for k in _WALK_TENSORS})
        _launch(name, load_library().nmr_march_walk, dev, params, n,
                ctypes.addressof(walk))
    return out


def _samples_out(out):
    return ((out["pos_k"], out["dt_k"], out["valid_k"], out["ts_k"]),
            out["t_end"], out["exited"], out["stopped"])


def advance(st, scene, opts, iters: int):
    """The advance pass -> (t, alive), each (n,).

    st: o, d (n, 3) f32; t, t_start, t_surf, surf_a (n,) f32; alive (n,)
    bool. iters probes a ray at most; on a CUDA tensor one launch of
    nmr_march_walk's advance form, a thread per ray that leaves its loop
    when the ray settles."""
    dev, n, args = _ray_args("advance", st, _STATE)
    if dev.type == "cpu":
        return advance_reference(st, scene, opts, iters)
    if n == 0 or iters <= 0:
        return args[2], args[6]
    out = _walk("advance", WALK_ADVANCE, dev, n, args, scene, opts, iters)
    return out["t_out"], out["alive_out"]


def init_walk(o, d, t, t_surface, alive, scene, opts):
    """init_rays' walk -> (t, alive), each (n,): o, d (n, 3) f32; t,
    t_surface (n,) f32; alive (n,) bool; at most opts.init_skip_iters
    probes (dt from the absolute t). On a CUDA tensor one launch of
    nmr_march_walk's init form."""
    dev, n, args = _ray_args("init_walk", {
        "o": o, "d": d, "t": t, "t_surf": t_surface, "alive": alive},
        _INIT_STATE)
    if dev.type == "cpu":
        return init_walk_reference(o, d, t, t_surface, alive, scene, opts)
    iters = opts.init_skip_iters
    if n == 0 or iters <= 0:
        return args[2], args[4]
    out = _walk("init_walk", WALK_INIT, dev, n, args, scene, opts, iters)
    return out["t_out"], out["alive_out"]


def samples(st, scene, opts):
    """A round's K sequential samples -> ((pos (K, n, 3), dt, valid, ts
    (K, n)), t_end, exited, surf_stopped (n,)), as samples_reference; the
    state as advance takes it. On a CUDA tensor one launch of
    nmr_march_walk's samples form."""
    dev, n, args = _ray_args("samples", st, _STATE)
    if dev.type == "cpu":
        return samples_reference(st, scene, opts)
    return _samples_out(_walk("samples", WALK_SAMPLES, dev, n, args, scene,
                              opts, 0))


def advance_samples(st, scene, opts, iters: int):
    """The advance pass and then the first round's K samples on the
    advanced rays -> ((t, alive), samples' outputs): advance's result and
    samples' on {**st, "t": t, "alive": alive}, as
    advance_samples_reference. On a CUDA tensor one
    launch of nmr_march_walk's fused form: a thread loads its ray once,
    advances it and carries it on into its K slots."""
    dev, n, args = _ray_args("advance_samples", st, _STATE)
    if dev.type == "cpu":
        return advance_samples_reference(st, scene, opts, iters)
    out = _walk("advance_samples", WALK_ADVANCE | WALK_SAMPLES, dev, n, args,
                scene, opts, max(int(iters), 0))
    return (out["t_out"], out["alive_out"]), _samples_out(out)


def composite(st, rnd, opts, stage: int = STAGE_BLEND | STAGE_SAMPLES):
    """A round's non-vector compositing -> {"rgba" (n, 4), "depth",
    "max_weight", "wn", "surf_a" (n,) f32, "alive" (n,) bool}, as
    composite_reference. st: rgba, surf (n, 4) f32; depth, max_weight,
    wn, surf_a, t, t_surf (n,) f32; alive (n,) bool. rnd: t_end (n,) f32,
    exited, surf_stopped (n,) bool; with STAGE_SAMPLES also valid (K, n)
    bool, ts (K, n) f32 and the network's rows: rgb (M, 3) f32, one per
    set slot of color ((K, n) bool; valid where absent), slots (M,) int64
    the flat slot of each row (torch.nonzero of that mask), and either
    sigma (M,) f32 (any stride: the density MLP's column 0) with dt (K,
    n) f32, or a dense alpha (K, n) f32. On a CUDA tensor one call of
    nmr_march_composite: the map from slots to rows (one scatter), then
    the kernel, which applies the activations and alpha itself. Rows
    that do not match the mask give a defined result there: a row whose
    slot lies outside the K * n slots is left out (the plain version
    raises), a slot of the mask with no row has alpha 0 (without a dense
    alpha) and colour 0, as in the plain version."""
    dev, n, args = _ray_args("composite", st, (
        "rgba", "depth", "max_weight", "wn", "surf_a", "t", "alive", "surf",
        "t_surf"))
    tensors = dict(zip(_COMPOSITE_IN, args))
    for k, dt in (("t_end", torch.float32), ("exited", torch.bool),
                  ("surf_stopped", torch.bool)):
        tensors[k] = _arg(k, rnd[k], dt, (n,), dev)
    K = 0
    sigma_stride = 0
    if stage & STAGE_SAMPLES:
        K = rnd["valid"].shape[0]
        for k, dt in (("valid", torch.bool), ("ts", torch.float32)):
            tensors[k] = _arg(k, rnd[k], dt, (K, n), dev)
        rgb = rnd["rgb"]
        m = rgb.shape[0]
        tensors["rgb"] = _arg("rgb", rgb, torch.float32, (m, 3), dev)
        tensors["slots"] = _arg("slots", rnd["slots"], torch.int64, (m,), dev)
        if "color" in rnd:
            tensors["color"] = _arg("color", rnd["color"], torch.bool, (K, n),
                                    dev)
        if "alpha" in rnd:
            tensors["alpha"] = _arg("alpha", rnd["alpha"], torch.float32,
                                    (K, n), dev)
        else:
            sigma = rnd["sigma"]
            if (sigma.dim() != 1 or sigma.shape[0] != m
                    or sigma.dtype != torch.float32 or sigma.device != dev):
                raise ValueError(f"sigma must be a float32 (M,) = ({m},) "
                                 f"tensor on {dev}, got {sigma.dtype} "
                                 f"{tuple(sigma.shape)} on {sigma.device}")
            tensors["sigma"] = sigma
            sigma_stride = sigma.stride(0)
            tensors["dt"] = _arg("dt", rnd["dt"], torch.float32, (K, n), dev)
    if dev.type == "cpu":
        return composite_reference(st, rnd, opts, stage)
    cfg = opts.config
    params = MarchParams(steps=K, deferred=int(opts.deferred_color),
                         stage=int(stage),
                         density_act=ACTIVATIONS[cfg.density_activation],
                         rgb_act=(ACT_EXP_CLAMPED
                                  if cfg.rgb_activation == "exponential"
                                  else ACTIVATIONS[cfg.rgb_activation]),
                         sat_alpha=np.float32(1.0 - opts.min_transmittance))
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"rgba": torch.empty((n, 4), **f32),
           **{k: torch.empty(n, **f32)
              for k in ("depth", "max_weight", "wn", "surf_a")},
           "alive": torch.empty(n, dtype=torch.bool, device=dev)}
    if n:
        m = tensors["rgb"].shape[0] if K else 0
        if m:
            tensors["rows"] = torch.empty(K * n, dtype=torch.int32, device=dev)
        ptrs = CompositeArgs(
            **{k: tensors[k].data_ptr() if k in tensors else None
               for k in _COMPOSITE_IN}, sigma_stride=sigma_stride, m=m,
            **{k + "_out": v.data_ptr() for k, v in out.items()})
        _launch("composite", load_library().nmr_march_composite, dev, params,
                n, ctypes.addressof(ptrs))
    return out


def _buffer(name, x, dtype, rows, device, width=None):
    """x, a contiguous dtype tensor on device with at least `rows` rows
    (of `width` columns), or ValueError."""
    shape_ok = (x.dim() == (1 if width is None else 2)
                and x.shape[0] >= rows
                and (width is None or x.shape[1] == width))
    if x.dtype != dtype or x.device != device or not shape_ok \
            or not x.is_contiguous():
        want = f"(>= {rows},)" if width is None else f"(>= {rows}, {width})"
        raise ValueError(f"{name} must be a contiguous {dtype} {want} tensor "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x


def _counter(name, x, device):
    """x, one int32 on device, or ValueError."""
    if (x.dtype != torch.int32 or x.numel() != 1 or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be one int32 on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x


def walk_list(frame, ids, n: int, scene, opts, iters, rows, count,
              n_dev=None):
    """The exact epoch's walk on the frame's arrays through its live-ray
    list. frame: o, d (N, 3) f32; t, t_start, t_surf, surf_a (N,) f32;
    alive (N,) bool. ids: int32, the list (ray ids[j] for j < its
    length). n: the list's length, or with n_dev (one int32 on the
    device) an upper bound of the length n_dev holds. iters: the advance
    and the first round's samples of each listed ray (alive implied, t
    and alive written back into the frame), or None: a later round's
    samples (the frame's alive read; t and alive left as they are).
    rows: list_buffers' (room for steps * n rows and entries); count: one
    int32 on the device that holds 0: the valid slots' rows are written
    from row 0 on, a ray's together in slot order from its first row,
    and count becomes their number; the rays' order is the list's in the
    plain version (walk_list_reference) and a warp's in the kernel.
    Returns nothing: read count for the rows. The plain version raises
    where count does not hold 0; the kernel, which cannot see it without
    a host read, then writes no row past the buffers. On a CUDA tensor
    one launch of nmr_march_walk's list form: a thread an entry, its rows
    allocated with one atomicAdd a warp and made by the warp a lane a row,
    each array of 32 rows written as one contiguous run."""
    K = opts.steps_per_round
    dev, N, args = _ray_args("walk_list", frame, _STATE)
    ids = _buffer("walk_list: ids", ids, torch.int32, n, dev)
    if not 0 < K <= MAX_LIST_STEPS:
        raise ValueError(f"walk_list takes 1-{MAX_LIST_STEPS} steps a "
                         f"round, got {K}")
    rows = {k: _buffer(f"rows[{k!r}]", rows[k], dt, r, dev, w)
            for k, dt, r, w in (
                ("pos01", torch.float32, K * n, 3),
                ("dir01", torch.float32, K * n, 3),
                ("ts", torch.float32, K * n, None),
                ("dt", torch.float32, K * n, None),
                ("first", torch.int32, n, None),
                ("mask", torch.uint8, _mask_bytes(K) * n, None),
                ("t_end", torch.float32, n, None),
                ("exited", torch.bool, n, None),
                ("stopped", torch.bool, n, None))}
    count = _counter("count", count, dev)
    if n_dev is not None:
        n_dev = _counter("n_dev", n_dev, dev)
    if dev.type == "cpu":
        return walk_list_reference(frame, ids, n, scene, opts, iters, rows,
                                   count, n_dev)
    if n == 0 or N == 0:
        return None
    mode = WALK_LIST | WALK_SAMPLES | (WALK_ADVANCE if iters is not None
                                       else 0)
    params, grid = _params(scene, opts, mode=mode,
                           iters=max(int(iters or 0), 0),
                           skip_iters=int(opts.skip_iters), steps=K)
    tensors = dict(zip(_STATE + ("grid", "box_lo", "box_hi", "local"),
                       args + _scene_args(scene, grid, dev)))
    tensors.update(
        t_out=args[2], alive_out=args[6], ids=ids, n_list=n_dev,
        train_min=_arg("train_min", scene["train_min"], torch.float32, (3,),
                       dev),
        train_max=_arg("train_max", scene["train_max"], torch.float32, (3,),
                       dev),
        row_pos01=rows["pos01"], row_dir01=rows["dir01"], row_ts=rows["ts"],
        row_dt=rows["dt"], row_first=rows["first"], row_count=count,
        slot_mask=rows["mask"],
        t_end=rows["t_end"], exited=rows["exited"], stopped=rows["stopped"])
    if args[2].data_ptr() != frame["t"].data_ptr() or \
            args[6].data_ptr() != frame["alive"].data_ptr():
        raise ValueError("walk_list writes t and alive in place: they must "
                         "be contiguous")
    cap = min(rows[k].shape[0] for k in ("pos01", "dir01", "ts", "dt"))
    walk = WalkArgs(**{k: tensors[k].data_ptr() if tensors.get(k) is not None
                       else None for k in _WALK_TENSORS}, row_cap=cap)
    _launch("walk_list", load_library().nmr_march_walk, dev, params, n,
            ctypes.addressof(walk))
    return None


def composite_list(frame, ids, n: int, rows, m: int, rgb, sigma, opts,
                   next_ids=None, next_count=None):
    """A round's compositing of the listed rays, in place in the frame's
    arrays. frame: rgba, surf (N, 4) f32; depth, max_weight, wn, surf_a,
    t, t_surf (N,) f32; alive (N,) bool; t is set to each ray's t_end.
    ids: int32, the list's n entries. rows: walk_list's buffers after the
    round's walk (first rows and slot bits, rows' ts and dt, the entries'
    t_end, exited, stopped); m: its row count; rgb (m, 3) f32 and sigma
    (m,) f32 (any stride: the density MLP's column 0): the network's
    pre-activation outputs on the rows. next_ids (int32, room for n) and
    next_count (one int32 on the device that holds 0): the rays still
    alive are written there from 0 on (the plain version in the list's
    order, the kernel a block's rays together) and next_count becomes
    their number; or None. Where next_count does not hold 0 the plain
    version raises and the kernel writes no entry past next_ids. On a
    CUDA tensor one launch of nmr_march_composite's list form."""
    K = opts.steps_per_round
    dev, N, args = _ray_args("composite_list", frame, _LIST_STATE)
    ids = _buffer("composite_list: ids", ids, torch.int32, n, dev)
    for k, dt, r in (("first", torch.int32, n),
                     ("mask", torch.uint8, _mask_bytes(K) * n),
                     ("ts", torch.float32, m),
                     ("dt", torch.float32, m), ("t_end", torch.float32, n),
                     ("exited", torch.bool, n), ("stopped", torch.bool, n)):
        _buffer(f"rows[{k!r}]", rows[k], dt, r, dev)
    rgb_rows = _arg("rgb", rgb, torch.float32, (m, 3), dev)
    if (sigma.dim() != 1 or sigma.shape[0] != m
            or sigma.dtype != torch.float32 or sigma.device != dev):
        raise ValueError(f"sigma must be a float32 (M,) = ({m},) tensor on "
                         f"{dev}, got {sigma.dtype} {tuple(sigma.shape)} on "
                         f"{sigma.device}")
    if (next_ids is None) != (next_count is None):
        raise ValueError("composite_list: next_ids and next_count go together")
    if next_ids is not None:
        _buffer("next_ids", next_ids, torch.int32, n, dev)
        _counter("next_count", next_count, dev)
    if dev.type == "cpu":
        return composite_list_reference(frame, ids, n, rows, m, rgb, sigma,
                                        opts, next_ids, next_count)
    if any(a.data_ptr() != frame[k].data_ptr()
           for k, a in zip(_LIST_STATE, args)):
        raise ValueError("composite_list writes the frame's state in place: "
                         "it must be contiguous")
    if n == 0:
        return None
    cfg = opts.config
    params = MarchParams(steps=K, deferred=int(opts.deferred_color),
                         stage=STAGE_BLEND | STAGE_SAMPLES,
                         density_act=ACTIVATIONS[cfg.density_activation],
                         rgb_act=(ACT_EXP_CLAMPED
                                  if cfg.rgb_activation == "exponential"
                                  else ACTIVATIONS[cfg.rgb_activation]),
                         sat_alpha=np.float32(1.0 - opts.min_transmittance))
    st = dict(zip(_LIST_STATE, args))
    tensors = {"rgba": st["rgba"], "depth": st["depth"],
               "max_weight": st["max_weight"], "wn": st["wn"],
               "surf_a": st["surf_a"], "t": st["t"], "alive": st["alive"],
               "surf": st["surf"], "t_surf": st["t_surf"],
               "t_end": rows["t_end"], "exited": rows["exited"],
               "surf_stopped": rows["stopped"], "rgb": rgb_rows}
    if m:
        tensors["sigma"] = sigma
    ptrs = CompositeArgs(
        **{k: tensors[k].data_ptr() if k in tensors else None
           for k in _COMPOSITE_IN},
        sigma_stride=sigma.stride(0) if m else 0, m=m,
        **{k + "_out": st[k].data_ptr() for k in _COMPOSITE_OUT},
        ids=ids.data_ptr(), row_first=rows["first"].data_ptr(),
        slot_mask=rows["mask"].data_ptr(),
        row_ts=rows["ts"].data_ptr(), row_dt=rows["dt"].data_ptr(),
        t_out=st["t"].data_ptr(),
        next_ids=None if next_ids is None else next_ids.data_ptr(),
        next_count=None if next_count is None else next_count.data_ptr(),
        next_cap=0 if next_ids is None else next_ids.shape[0])
    _launch("composite_list", load_library().nmr_march_composite, dev,
            params, n, ctypes.addressof(ptrs))
    return None



# ---------------------------------------------------------------------------
# The contract
# ---------------------------------------------------------------------------

def _allowed(n):
    return max(MISMATCH_MIN, math.ceil(MISMATCH_FRACTION * n))


def _ray_diffs(kind, out_k, out_p):
    """-> (rays whose flags differ, rays whose t values differ in any bit,
    [(t values of out_k, of out_p)] (rows, n), [(value tensors)] compared
    bit for bit)."""
    if kind == "walk":
        (tk, ak), (tp, ap) = out_k, out_p
        flags_k, flags_p = ak[None], ap[None]
        ts = [(tk[None], tp[None])]
        exact = ts
    elif kind == "samples":
        (pk, dk, vk, sk), tek, exk, ssk = out_k
        (pp, dp, vp, sp), tep, exp_, ssp = out_p
        flags_k = torch.cat([vk, exk[None], ssk[None]])
        flags_p = torch.cat([vp, exp_[None], ssp[None]])
        ts = [(torch.cat([sk, tek[None]]), torch.cat([sp, tep[None]]))]
        exact = [(pk, pp), (dk, dp)] + ts
    else:
        raise ValueError(f"compare_with_plain: unknown kind {kind!r}")
    n = ts[0][1].shape[1]
    flag_diff = (flags_k != flags_p).any(dim=0)
    value_diff = torch.zeros_like(flag_diff)
    for a, b in exact:
        value_diff |= (a != b).reshape(a.shape[0], n, -1).any(dim=2).any(dim=0)
    return flag_diff, value_diff, ts, exact


def compare_with_plain(kind: str, out_k, out_p) -> dict:
    """A kernel's outputs against its plain version's on the same inputs
    -> counts, worst differences and `ok` under the contract.

    kind "walk" (advance, init_walk: (t, alive)), "samples" (samples'
    outputs) or "advance_samples" (((t, alive), samples' outputs)): rays
    whose flags (alive; valid, exited, surf_stopped) or whose t values (t;
    every slot's t, position and dt, t_end) differ in any bit number at
    most max(4, ceil(1e-4 x rays)); where the flags agree, the t values
    lie at most one MAX_CONE_STEPSIZE apart. kind "composite" (dicts of
    composite's outputs): the alive masks differ on at most as many rays,
    every float output within COMPOSITE_ATOL. The composite kernel
    departs from composite_reference in one case that this contract does
    not excuse: a NaN colour row on a slot its loop does not use (the ray
    saturated before it, or composites no more) leaves the ray's colour
    alone, where the plain version's 0 weight times NaN turns it to
    NaN."""
    if kind == "composite":
        n = out_p["alive"].shape[0]
        flag_diff = out_k["alive"] != out_p["alive"]
        err = max(float((out_k[k] - out_p[k]).abs().max()) if n else 0.0
                  for k in ("rgba", "depth", "max_weight", "wn", "surf_a"))
        rays = int(flag_diff.sum())
        ok = rays <= _allowed(n) and err <= COMPOSITE_ATOL
        return {"rays": n, "mismatched_rays": rays, "flag_mismatches": rays,
                "allowed": _allowed(n), "max_step_diff": 0.0,
                "max_abs_err": err, "ok": ok}
    parts = ([("walk", out_k[0], out_p[0]), ("samples", out_k[1], out_p[1])]
             if kind == "advance_samples" else [(kind, out_k, out_p)])
    diffs = [_ray_diffs(*part) for part in parts]
    flag_diff = torch.stack([f for f, _, _, _ in diffs]).any(dim=0)
    value_diff = torch.stack([v for _, v, _, _ in diffs]).any(dim=0)
    n = flag_diff.shape[0]
    rays = int((flag_diff | value_diff).sum())
    agree = ~flag_diff
    step = 0.0
    if bool(agree.any()):
        step = max(float((a - b)[:, agree].abs().max())
                   for _, _, ts, _ in diffs for a, b in ts)
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for _, _, _, exact in diffs for a, b in exact)
    ok = rays <= _allowed(n) and step <= STEP_TOL
    return {"rays": n, "mismatched_rays": rays,
            "flag_mismatches": int(flag_diff.sum()), "allowed": _allowed(n),
            "max_step_diff": step, "max_abs_err": err, "ok": ok}

"""The exact march's per-ray loops (ops/march_cuda.py, csrc/march.cu):
the plain versions against the JAX package, a scalar model of each
kernel against the plain versions, the wrappers' validation, and the
kernels themselves on the card.

Scenes at small size: 64x48 rays into the 128^3 sphere occupancy of
tests/helpers.make_sphere_density (one cascade) and into the
three-cascade grid of tests/test_multicascade.make_cascaded_grid, each
with and without a surface payload, on every route of the empty-space
probe (`march_cuda.probe_route`): the jump grid, the clearance grid, the
clearance pyramid and the per-voxel DDA (and the DDA's constant-dt form
and the jump grid under cone stepping).

Tolerances:
- plain versions against JAX (init_rays, _advance_pass, _march_round at
  float32 and jitter off): the packages' float32 ops round alike but for
  the transcendental functions (_ladder_jump's log and exp) and XLA's
  fusion, so a ray whose quotient lands within roundoff of an integer
  under a ceil may take one step more or less. Such rays are counted and
  held to 0.5% of the batch (tests/test_torch_multicascade.py's share
  for the probes); the other rays agree in every flag, and their t to
  rtol 1e-6; the round's colour, depth and weights to 1e-5 absolute
  (tests/test_torch_march.py's frame tolerance), alpha and max weight
  are those of float32 MLPs on both sides.
- the scalar model against the plain versions: equal bit for bit on every
  ray. The model is numpy float32 scalar code that follows each kernel's
  loop with its early exits, line for line (the fused walk as the advance
  and then the samples in one pass, divisions by powers of two as
  products, cells as integers); it takes log and exp
  from torch (the plain version's own functions on this CPU, as the
  kernels take the card's logf and expf, which aten calls there).
- x / 2^k against x * 2^-k: equal, bit for bit.
- the kernels on the card (marked `cuda`, skipped without a card): the
  fused walk bit for bit the advance then the samples, every kernel under
  march_cuda.compare_with_plain's contract against the card's plain
  version, and the card's division by a Python scalar against the CPU's.
  On a machine where another `tests` package shadows this directory, run
  them as `python -c "import os, sys, types, pytest; m =
  types.ModuleType('tests'); m.__path__ = [os.path.abspath('tests')];
  sys.modules['tests'] = m; sys.exit(pytest.main(['tests/
  test_torch_march_kernels.py', '-m', 'cuda', '-q']))"`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops.network import init_params
from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.ops import march_cuda as mc
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops.network import (apply_density_activation,
                                                apply_rgb_activation,
                                                params_from_jax)
from tests.helpers import make_sphere_density
from tests.test_multicascade import CFG4, make_cascaded_grid
from tests.test_torch_march import _np_params, _tcfg

torch.set_num_threads(1)

W, H = 64, 48
CONE = 1.0 / 256.0
JC1 = JCfg(n_levels=4, log2_hashmap_size=11, base_resolution=16,
           per_level_scale=1.5)
JC4 = dataclasses.replace(CFG4, n_levels=4, log2_hashmap_size=11)
SHARE = 0.005          # rays allowed one step apart (see the docstring)
F = np.float32

# route case -> (multi-cascade scene, march options)
ROUTES = {
    "jump": (False, {}),
    "dist": (False, {"dist_advance": True}),
    "dist_mips": (True, {"dist_advance": True, "cone_angle": CONE}),
    "dda": (True, {"cone_angle": CONE}),
    # the DDA's closed form (constant dt at a floor mip) and the jump grid
    # under cone stepping
    "dda_min_mip": (False, {"min_mip": 1}),
    "jump_cone": (False, {"cone_angle": CONE}),
}
FOUR = ("jump", "dist", "dist_mips", "dda")
ROUTE_OF = {"jump": mc.ROUTE_JUMP, "dist": mc.ROUTE_DIST,
            "dist_mips": mc.ROUTE_DIST_MIPS, "dda": mc.ROUTE_DDA,
            "dda_min_mip": mc.ROUTE_DDA, "jump_cone": mc.ROUTE_JUMP}


# ---------------------------------------------------------------------------
# Scenes, rays and states
# ---------------------------------------------------------------------------

_OCC = {}


def _occupancy(multi):
    if multi not in _OCC:
        if multi:
            grid, mcasc = make_cascaded_grid(), 2
        else:
            grid, mcasc = make_sphere_density(radius=0.2, value=1.0), 0
        _OCC[multi] = np.asarray(jocc.build_occupancy(jnp.asarray(grid),
                                                      mcasc))
    return _OCC[multi]


def _scenes(multi):
    """-> (JAX scene, port scene) with every probe grid."""
    occ = _occupancy(multi)
    lo, hi = (-1.5, 2.5) if multi else (0.0, 1.0)
    box = (np.full(3, lo), np.full(3, hi), np.eye(3), np.full(3, lo),
           np.full(3, hi))
    js, ts = jrm.make_scene(occ, *box), trm.make_scene(occ, *box)
    js["dist"] = jocc.build_dist_grid(js["occ"])
    ts["dist"] = tocc.build_dist_grid(ts["occ"])
    if multi:
        js["dist_mips"] = jocc.build_dist_grid_cascades(js["occ"], 2)
        ts["dist_mips"] = tocc.build_dist_grid_cascades(ts["occ"], 2)
    return js, ts


def _options(route, **kw):
    multi, extra = ROUTES[route]
    jc = JC4 if multi else JC1
    kw = {"jitter": False, "compute_dtype": "float32", **extra, **kw}
    return jrm.MarchOptions(config=jc, **kw), trm.MarchOptions(
        config=_tcfg(jc), **kw)


def _rays(multi, surface, seed=0):
    """64x48 camera rays through the scene, a few along the axes, and a
    surface payload on 30% of them (alpha 1 or 0.5) -> numpy (o, d, surf
    (n, 4), t_surf (n,))."""
    rng = np.random.default_rng(seed)
    if multi:
        cam = np.array([[0.45, 0, 0, 0.1], [0, 0.4, 0, -0.05],
                        [0, 0, 1, -3.0]], np.float32)
    else:
        cam = np.array([[0.5, 0, 0, 0.02], [0, 0.4, 0, 0.01],
                        [0, 0, 1, -1.2]], np.float32)
    o, d = trm.camera_rays(cam, W, H)
    o, d = o.copy(), d.copy()
    d[:3] = np.eye(3, dtype=np.float32)[[2, 2, 2]]
    d[3] = np.array([0.0, 0.6, 0.8], np.float32)
    n = o.shape[0]
    surf = np.zeros((n, 4), np.float32)
    t_surf = np.zeros(n, np.float32)
    if surface:
        has = rng.uniform(size=n) < 0.3
        span = (2.5, 5.0) if multi else (0.8, 1.8)
        t_surf[has] = rng.uniform(*span, has.sum())
        surf[has, :3] = rng.uniform(0, 1, (has.sum(), 3))
        surf[has, 3] = np.where(rng.uniform(size=has.sum()) < 0.5, 1.0, 0.5)
        surf[has, :3] *= surf[has, 3:]
    return o, d, surf, t_surf


def _state(o, d, surf, t_surf, t, t_start, alive, seed=1):
    """A march state dict of numpy arrays at (t, alive), its colour half
    accumulated on some rays so that the round's saturation is reached."""
    rng = np.random.default_rng(seed)
    n = o.shape[0]
    rgba = np.zeros((n, 4), np.float32)
    part = rng.uniform(size=n) < 0.3
    rgba[part, 3] = rng.uniform(0.2, 0.985, part.sum())
    rgba[part, :3] = rng.uniform(0, 1, (part.sum(), 3)) * rgba[part, 3:]
    return {"o": o, "d": d, "surf": surf, "t_surf": t_surf,
            "t_start": np.asarray(t_start, np.float32),
            "t": np.asarray(t, np.float32), "rgba": rgba,
            "depth": np.where(part, 0.7, 0.0).astype(np.float32),
            "max_weight": np.where(part, 0.05, 0.0).astype(np.float32),
            "alive": np.asarray(alive, bool),
            "surf_a": np.where(alive, surf[:, 3], 0.0).astype(np.float32),
            "wn": np.where(part, rgba[:, 3] * 0.5, 0.0).astype(np.float32)}


def _torch(st):
    return {k: torch.as_tensor(np.array(v)) for k, v in st.items()}


def _jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _numpy(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _init_state(route, surface):
    """init_rays on the port (plain) -> the numpy state every test of the
    route starts from, and the port's options and scene."""
    multi = ROUTES[route][0]
    _, tscene = _scenes(multi)
    _, topts = _options(route)
    o, d, surf, t_surf = _rays(multi, surface)
    t, t_start, alive = trm.init_rays(tscene, torch.as_tensor(o),
                                      torch.as_tensor(d),
                                      torch.as_tensor(t_surf), topts)
    return _state(o, d, surf, t_surf, t.numpy(), t_start.numpy(),
                  alive.numpy()), topts, tscene


# ---------------------------------------------------------------------------
# (a) The plain versions against JAX
# ---------------------------------------------------------------------------

def _held(t_got, t_want, flags_got, flags_want, step):
    """-> rays off: flags differ or t beyond rtol 1e-6 (each of those one
    step apart where the flags agree); at most SHARE of the rays."""
    t_got, t_want = np.asarray(t_got), np.asarray(t_want)
    flag_off = np.zeros(t_got.shape[-1], bool)
    for a, b in zip(flags_got, flags_want):
        flag_off |= (np.asarray(a) != np.asarray(b)).reshape(
            -1, t_got.shape[-1]).any(axis=0)
    t_off = (np.abs(t_got - t_want)
             > 1e-6 * np.maximum(np.abs(t_want), 1.0)).reshape(
        -1, t_got.shape[-1]).any(axis=0)
    gap = np.abs(t_got - t_want).reshape(-1, t_got.shape[-1]).max(axis=0)
    assert (gap[t_off & ~flag_off] <= 1.01 * step).all(), gap[t_off].max()
    off = flag_off | t_off
    assert off.sum() <= SHARE * off.size, (flag_off.sum(), t_off.sum())
    return off


@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("route", FOUR + ("dda_min_mip", "jump_cone"))
def test_plain_loops_match_jax(route, surface):
    """init_rays' walk, the advance pass and two sequential rounds: the
    port's plain versions against the JAX package's functions on the
    same state."""
    multi = ROUTES[route][0]
    jscene, tscene = _scenes(multi)
    jopts, topts = _options(route)
    assert mc.probe_route(tscene, topts)[0] == ROUTE_OF[route]
    step = C.MAX_CONE_STEPSIZE
    o, d, surf, t_surf = _rays(multi, surface)

    jt, jts, ja = jrm.init_rays(jscene, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_surf), jnp.asarray(surf[:, 3]),
                                jopts)
    tt, tts, ta = trm.init_rays(tscene, torch.as_tensor(o),
                                torch.as_tensor(d), torch.as_tensor(t_surf),
                                topts)
    off = _held(tt.numpy(), jt, [ta.numpy()], [ja], step)
    _held(tts.numpy(), jts, [], [], step)
    assert ta.any()

    st = _state(o, d, surf, t_surf, np.asarray(jt), np.asarray(jts),
                np.asarray(ja))
    jadv = jrm._advance_pass(_jax(st), jscene, jopts, 48)
    tadv = trm._advance_pass(_torch(st), tscene, topts, 48)
    off |= _held(tadv["t"].numpy(), jadv["t"], [tadv["alive"].numpy()],
                 [jadv["alive"]], step)

    cfg = JC4 if multi else JC1
    params = init_params(jax.random.PRNGKey(5), cfg)
    params = {**params, "grid": params["grid"] * 300.0}
    net = params_from_jax(_np_params(params), _tcfg(cfg))
    jst = _numpy(jadv)
    tst = _torch(jst)
    for _ in range(2):
        jst = _numpy(jrm._march_round(_jax(jst), params, jscene, jopts))
        tst = trm._march_round(tst, net, tscene, topts)
        off |= _held(tst["t"].numpy(), jst["t"], [tst["alive"].numpy()],
                     [jst["alive"]], step)
        keep = ~off
        for k in ("rgba", "depth", "max_weight", "wn", "surf_a"):
            np.testing.assert_allclose(tst[k].numpy()[keep], jst[k][keep],
                                       atol=1e-5, err_msg=k)
    print(f"{route}: rays one step apart {off.sum()} of {off.size}")
    assert (tst["rgba"][:, 3] > 0.5).any()


# ---------------------------------------------------------------------------
# (b) A scalar model of each kernel against the plain versions
# ---------------------------------------------------------------------------
# csrc/march.cu, line for line, in numpy float32 scalars: every operation
# rounds as the kernel's does (the build takes -fmad=false; fmaf only in
# the `local` product). Each ray leaves its loop where the kernel's
# thread does.

F32_MAX = F(np.finfo(np.float32).max)


def _nmin(a, b):
    return a if (a != a or a < b) else b


def _nmax(a, b):
    return a if (a != a or a > b) else b


def _lo(x, lo):
    return lo if x < lo else x


def _hi(x, hi):
    return hi if x > hi else x


def _cell_i(q):
    """cell_i: the saturating integer conversion, NaN to 0."""
    v = q * F(128)
    if v != v:
        return 0
    return int(min(max(np.trunc(np.float64(v)), 0), 127))


def _fma(a, b, c):
    """fmaf for the identity-like `local` products (exact there)."""
    return F(np.float64(a) * np.float64(b) + np.float64(c))


def _torch_fn(fn, x):
    return F(fn(torch.tensor([x], dtype=torch.float32))[0].item())


def _ldexp(x, e):
    return F(np.ldexp(F(x), e))


def _frexp_e(x):
    return int(np.frexp(F(x))[1])


class _P:
    """A MarchParams as float32 scalars and ints."""

    def __init__(self, params, grid):
        for name, _ in params._fields_:
            v = getattr(params, name)
            setattr(self, name, F(v) if isinstance(v, float) else int(v))
        self.grid = grid.reshape(-1).numpy()


def _box(scene):
    lo = [F(x) for x in scene["render_min"].numpy()]
    hi = [F(x) for x in scene["render_max"].numpy()]
    m = [F(x) for x in scene["local"].numpy().reshape(-1)]
    identity = (m == [F(i % 4 == 0) for i in range(9)]
                and np.isfinite(lo + hi).all())
    return lo, hi, m, identity


def _local_row(box, r, x):
    m = box[2]
    return _fma(x[2], m[3 * r + 2], _fma(x[1], m[3 * r + 1], x[0] * m[3 * r]))


def _contains(box, p):
    inside = True
    for r in range(3):
        q = p[r] if box[3] else _local_row(box, r, p)
        inside = inside and q >= box[0][r] and q <= box[1][r]
    return inside


def _exit_t(box, o, d):
    tmin = tmax = F(0)
    for r in range(3):
        ol = _local_row(box, r, o)
        inv = F(1) / _local_row(box, r, d)
        t0 = (box[0][r] - ol) * inv
        t1 = (box[1][r] - ol) * inv
        a, c = _nmin(t0, t1), _nmax(t0, t1)
        tmin = a if r == 0 else _nmax(tmin, a)
        tmax = c if r == 0 else _nmin(tmax, c)
    if tmin > tmax:
        tmax = F32_MAX
    return F(-np.inf) if tmax >= F(3e38) else tmax


def _calc_dt(t, P):
    if P.cone == 0:
        return P.dt_min
    return _hi(_lo(t * P.cone, P.dt_min), P.dt_max)


def _mip_from_pos(p, mcasc):
    m = _nmax(_nmax(abs(p[0] - F(0.5)), abs(p[1] - F(0.5))),
              abs(p[2] - F(0.5)))
    return min(max(_frexp_e(m) + 1, 0), mcasc)


def _mip_from_dt(dt, p, mcasc):
    mip = _mip_from_pos(p, mcasc)
    x = dt * F(256)
    return mip if x < F(1) else min(max(_frexp_e(x), mip), mcasc)


def _dist_to_next_voxel(p, d, idir, k):
    """at res = 2^(7 - k): the division by res a product with 2^(k - 7)"""
    res, inv_res = _ldexp(1, 7 - k), _ldexp(1, k - 7)
    t = F(0)
    for i in range(3):
        x = res * p[i]
        s = (F(1) if d[i] > 0 else (F(-1) if d[i] < 0 else F(0))) \
            + (F(1) if d[i] == 0 else F(0))
        tt = (np.floor((x + F(0.5)) + F(0.5) * s) - x) * idir[i]
        t = tt if i == 0 else _nmin(t, tt)
    return _lo(t * inv_res, F(0))


def _advance_to_next_voxel(t, P, p, d, idir, k):
    t_target = t + _dist_to_next_voxel(p, d, idir, k)
    if P.cone == 0:
        n = _lo(np.ceil((t_target - t) / P.dt_min), F(1))
        return t + n * P.dt_min
    t1 = t
    for _ in range(8):
        if not t1 < t_target:
            break
        t1 = t1 + _calc_dt(t1, P)
    return _nmax(t1, t + _calc_dt(t, P))


def _ladder(t, target, P):
    if P.cone == 0:
        n = _lo(np.ceil((target - t) / P.dt_min), F(1))
        return t + n * P.dt_min
    out = t
    if t < P.t1:
        na = np.ceil(_lo(_hi(target, P.t1_end) - t, F(0)) / P.dt_min)
        out = t + na * P.dt_min
    if out < target and out >= P.t1 and out < P.t2:
        ratio = _lo(_hi(target, P.t2_cap) / _lo(out, F(1e-30)), F(1))
        nb = np.ceil(_torch_fn(torch.log, ratio) / P.lg)
        out = out * _torch_fn(torch.exp, nb * P.lg)
    if out < target and out >= P.t2:
        nc = np.ceil((target - out) / P.dt_max)
        out = out + nc * P.dt_max
    return _nmax(out, t + _calc_dt(t, P))


def _clamp_flat(flat, P):
    return 0 if flat < 0 else min(flat, len(P.grid) - 1)


def _div_const(x, c, inv_c):
    return x * inv_c if inv_c != 0 else x / c


def _probe(P, p, t, d, idir, dt):
    """-> (occupied, t advanced): probe<ROUTE>."""
    g, r = P.grid, P.route
    if r in (mc.ROUTE_JUMP, mc.ROUTE_DDA):
        if r == mc.ROUTE_JUMP:
            c = [_cell_i(x) for x in p]
            lv = int(g[(c[2] * 128 + c[1]) * 128 + c[0]])
            occ, k = lv == 255, min(lv, 4)
        else:
            mip = max(_mip_from_dt(dt, p, P.max_cascade), P.min_mip)
            scale = _ldexp(1, -mip)
            c = [_cell_i((x - F(0.5)) * scale + F(0.5)) for x in p]
            flat = _clamp_flat(((mip * 128 + c[2]) * 128 + c[1]) * 128 + c[0],
                               P)
            occ, k = g[flat] != 0, mip
        return occ, None if occ else _advance_to_next_voxel(t, P, p, d, idir, k)
    vox = F(1 / 128)
    if r == mc.ROUTE_DIST:
        vi = [F(_cell_i(x)) for x in p]
        k = F(g[(int(vi[2]) * 128 + int(vi[1])) * 128 + int(vi[0])])
        delta = F(0)
        for i in range(3):
            bound = (vi[i] + k) * vox if d[i] > 0 else (vi[i] - (k - F(1))) * vox
            tt = F(1e9) if d[i] == 0 else (bound - p[i]) / d[i]
            delta = tt if i == 0 else _nmin(delta, tt)
        delta = _lo(delta, F(0))
        return k == 0, t + _lo(np.ceil(delta / P.dt_min), F(1)) * P.dt_min
    mip = max(_mip_from_dt(dt, p, P.max_cascade), P.min_mip)
    s, inv_s = _ldexp(1, mip), _ldexp(1, -mip)
    q = [(x - F(0.5)) * inv_s + F(0.5) for x in p]
    cell = [F(_cell_i(x)) for x in q]
    flat = _clamp_flat(((mip * 128 + int(cell[2])) * 128 + int(cell[1])) * 128
                       + int(cell[0]), P)
    k = F(g[flat])
    ball = cube = F(0)
    for i in range(3):
        zero = d[i] == 0
        safe_d = F(1) if zero else d[i]
        bound = (cell[i] + k) * vox if d[i] > 0 else (cell[i] - (k - F(1))) * vox
        tt = F(1e9) if zero else (bound - q[i]) / (safe_d * inv_s)
        cb = F(0.5) + F(0.5) * s if d[i] > 0 else F(0.5) - F(0.5) * s
        tc = F(1e9) if zero else (cb - p[i]) / safe_d
        ball = tt if i == 0 else _nmin(ball, tt)
        cube = tc if i == 0 else _nmin(cube, tc)
    delta = _nmin(_lo(ball, F(0)), _lo(cube, F(0)) + vox)
    if P.cone > 0:
        tau_next = _div_const(_ldexp(1, max(_frexp_e(dt * F(256)), 0)),
                              P.tau_den, P.inv_tau_den)
        tau = _div_const(dt, P.cone, P.inv_cone)
        dtmip = F(1e9) if dt >= P.dtmip_cap else _lo(tau_next - tau, F(0)) + dt
        delta = _nmin(delta, dtmip)
    return k == 0, _ladder(t, t + delta, P)


def _ray(st, i):
    o = [F(x) for x in st["o"][i]]
    d = [F(x) for x in st["d"][i]]
    return o, d, [F(1) / x for x in d]


def _at(o, d, t):
    return [o[c] + d[c] * t for c in range(3)]


def _model_advance(P, box, st):
    n = len(st["t"])
    t_out, alive_out = np.array(st["t"], np.float32), np.array(st["alive"])
    for i in range(n):
        t, alive = F(st["t"][i]), bool(st["alive"][i])
        if alive and P.iters > 0:
            o, d, idir = _ray(st, i)
            ts, t0 = F(st["t_surf"][i]), F(st["t_start"][i])
            surf_live = ts > 0 and F(st["surf_a"][i]) > 0
            t_exit = _exit_t(box, o, d)
            for _ in range(P.iters):
                pending = surf_live and t >= ts
                inside = t <= t_exit
                if pending or (not inside and surf_live):
                    t = ts
                    break
                if not inside:
                    alive = False
                    break
                occ, adv = _probe(P, _at(o, d, t), t, d, idir,
                                  _calc_dt(t - t0, P))
                if occ:
                    break
                t = adv
        t_out[i], alive_out[i] = t, alive
    return t_out, alive_out


def _model_init_walk(P, box, st):
    n = len(st["t"])
    t_out, alive_out = np.array(st["t"], np.float32), np.array(st["alive"])
    for i in range(n):
        t, alive = F(st["t"][i]), bool(st["alive"][i])
        if alive and P.iters > 0:
            o, d, idir = _ray(st, i)
            ts = F(st["t_surf"][i])
            for _ in range(P.iters):
                if ts > 0 and t > ts:
                    t = ts
                    break
                p = _at(o, d, t)
                if not _contains(box, p):
                    if ts > 0:
                        t = ts
                    else:
                        alive = False
                    break
                occ, adv = _probe(P, p, t, d, idir, _calc_dt(t, P))
                if occ:
                    break
                t = adv
        t_out[i], alive_out[i] = t, alive
    return t_out, alive_out


def _model_samples(P, box, st):
    n, K = len(st["t"]), P.steps
    pos_k = np.zeros((K, n, 3), np.float32)
    dt_k, ts_k = np.zeros((K, n), np.float32), np.zeros((K, n), np.float32)
    valid_k = np.zeros((K, n), bool)
    t_end = np.zeros(n, np.float32)
    exited_out, stopped_out = np.zeros(n, bool), np.zeros(n, bool)
    for i in range(n):
        o, d, idir = _ray(st, i)
        ts, t0 = F(st["t_surf"][i]), F(st["t_start"][i])
        surf_full = F(st["surf_a"][i]) >= 1
        alive = bool(st["alive"][i])
        t = F(st["t"][i])
        gen_alive, exited, stopped = alive, False, False
        for k in range(K):
            status = 0 if gen_alive else -1
            for _ in range(P.skip_iters):
                if status != 0:
                    break
                p = _at(o, d, t)
                if ts > 0 and t > ts and surf_full:
                    status = 3
                elif not _contains(box, p):
                    status = 2
                else:
                    occ, adv = _probe(P, p, t, d, idir, _calc_dt(t - t0, P))
                    if occ:
                        status = 1
                    else:
                        t = adv
            found = status == 1
            dt = _calc_dt(t - t0, P)
            pos_k[k, i] = _at(o, d, t)
            dt_k[k, i], valid_k[k, i], ts_k[k, i] = dt, found, t
            exited = exited or status == 2
            stopped = stopped or status == 3
            t = t + dt if found else (ts if status == 3 else t)
            gen_alive = gen_alive and (found or status == 0)
        t_end[i] = t
        exited_out[i], stopped_out[i] = exited and alive, stopped and alive
    return (pos_k, dt_k, valid_k, ts_k), t_end, exited_out, stopped_out


def _act_rows(x, kind):
    """activate() on every row at once, with torch's functions over the
    whole array as the plain version applies them (aten's CPU sigmoid
    rounds its vector and scalar paths apart)."""
    x = torch.as_tensor(np.array(x))
    if kind == mc.ACT_EXP_CLAMPED:
        return apply_rgb_activation(x, "exponential").numpy()
    name = {v: k for k, v in mc.ACTIVATIONS.items()}[kind]
    return apply_density_activation(x, name).numpy()


def _model_composite(P, st, rnd):
    """composite_kernel: a slot the loop uses finds its row in the row
    map (row_map_kernel's scatter of the rows' slots that lie inside the
    round) and reads its alpha (dense, or 1 - exp(-sigma dt) from the
    row's activated density and the slot's dt) and its activated colour;
    a slot of the mask with no row reads alpha 0 (without a dense alpha)
    and colour 0; one the loop does not use adds a weight of 0."""
    n = len(st["t"])
    valid = rnd["valid"]
    color = rnd.get("color", valid)
    slots = np.asarray(rnd["slots"], np.int64)
    inside = (slots >= 0) & (slots < valid.size)
    rows = np.full(valid.size, -1, np.int64)
    rows[slots[inside]] = np.nonzero(inside)[0]
    rgb_rows = _act_rows(rnd["rgb"], P.rgb_act)
    sigma_rows = (None if "alpha" in rnd
                  else _act_rows(rnd["sigma"], P.density_act))
    out = {"rgba": np.zeros((n, 4), np.float32),
           **{k: np.zeros(n, np.float32)
              for k in ("depth", "max_weight", "wn", "surf_a")},
           "alive": np.zeros(n, bool)}
    for i in range(n):
        c = [F(x) for x in st["rgba"][i]]
        sc = [F(x) for x in st["surf"][i]]
        depth, max_w = F(st["depth"][i]), F(st["max_weight"][i])
        wn, sa, ts = F(st["wn"][i]), F(st["surf_a"][i]), F(st["t_surf"][i])
        alive = bool(st["alive"][i])
        exited, stopped = bool(rnd["exited"][i]), bool(rnd["surf_stopped"][i])
        comp = alive
        if P.stage & mc.STAGE_BLEND:
            t_payload = (F(st["t"][i]) if exited
                         else (ts if stopped else F(rnd["t_end"][i])))
            if comp and ts > 0 and t_payload > ts and sa > 0:
                w = sa * (F(1) - c[3])
                c = [c[j] + sc[j] * w for j in range(3)] + [c[3] + w]
                sa = F(0)
                if c[3] > F(0.99):
                    inv = F(1) / _lo(c[3], F(1e-9))
                    c = [x * inv for x in c]
                    if P.deferred:
                        wn = wn * inv
                    comp = False
        if P.stage & mc.STAGE_SAMPLES:
            for k in range(P.steps):
                use = comp and bool(valid[k, i]) and alive
                w, rgb = F(0), [F(0)] * 3
                if use:
                    row = int(rows[k * n + i])
                    owns = bool(color[k, i]) and row >= 0
                    alpha = F(0)
                    if "alpha" in rnd:
                        alpha = F(rnd["alpha"][k, i])
                    elif owns:
                        sig = F(sigma_rows[row])
                        alpha = F(1) - _torch_fn(torch.exp,
                                                 -sig * F(rnd["dt"][k, i]))
                    if owns:
                        rgb = [F(x) for x in rgb_rows[row]]
                    w = alpha * (F(1) - c[3])
                c = [c[j] + rgb[j] * w for j in range(3)] + [c[3] + w]
                if P.deferred:
                    wn = wn + w
                done = use and c[3] > P.sat_alpha
                upd = w > max_w
                if upd:
                    max_w = w
                if upd and use:
                    depth = F(rnd["ts"][k, i])
                if done:
                    inv = F(1) / _lo(c[3], F(1e-9))
                    c = [x * inv for x in c]
                    if P.deferred:
                        wn = wn * inv
                    comp = False
            ended = exited or stopped
            if comp and ended and sa > 0:
                T = F(1) - c[3]
                c = [c[j] + sc[j] * T for j in range(4)]
            comp = comp and not ended
        out["rgba"][i] = c
        out["depth"][i], out["max_weight"][i], out["wn"][i] = depth, max_w, wn
        out["surf_a"][i], out["alive"][i] = sa, comp
    return out


def _bits_equal(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    bad = got != want
    assert not bad.any(), f"{name}: {int(bad.sum())} elements differ"


@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_model_walks_equal_plain(route, surface):
    """The advance and init-walk kernels' loops, modelled per ray with
    their early exits, equal the masked plain versions bit for bit."""
    st, topts, tscene = _init_state(route, surface)
    box = _box(tscene)
    params, grid = mc._params(tscene, topts, iters=48)
    t, alive = mc.advance_reference(_torch(st), tscene, topts, 48)
    with np.errstate(all="ignore"):
        mt, ma = _model_advance(_P(params, grid), box, st)
    _bits_equal(mt, t.numpy(), "advance t")
    _bits_equal(ma, alive.numpy(), "advance alive")
    assert (t.numpy() != st["t"]).any()

    # the walk from init_rays' start (the state before its walk)
    o, d, _, t_surf = (torch.as_tensor(st[k]) for k in ("o", "d", "surf",
                                                          "t_surf"))
    t0, _, a0 = trm.init_rays(tscene, o, d, t_surf,
                              dataclasses.replace(topts, init_skip_iters=0))
    t, alive = mc.init_walk_reference(o, d, t0, t_surf, a0, tscene, topts)
    params, grid = mc._params(tscene, topts, iters=topts.init_skip_iters)
    with np.errstate(all="ignore"):
        mt, ma = _model_init_walk(_P(params, grid), box, {
            "o": st["o"], "d": st["d"], "t": t0.numpy(), "t_surf": st["t_surf"],
            "alive": a0.numpy()})
    _bits_equal(mt, t.numpy(), "init walk t")
    _bits_equal(ma, alive.numpy(), "init walk alive")


def _odd_rays(n=2048, seed=7):
    """Rays into the three-cascade scene with zero, tiny (normal, and
    below 2^-100) and negative direction components, two components
    equal (a tie between quotients), and surfaces before the box, inside
    it and behind it -> numpy (o, d, t_surf)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.4, 2.4, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    q = n // 8
    d[:q, 0] = 0.0                                   # a zero component
    d[q:2 * q, 1] = np.float32(1e-8)                 # tiny, normal
    d[2 * q:3 * q, 2] = -np.float32(2.0 ** -110)     # below 2^-100
    d[3 * q:4 * q, 1] = d[3 * q:4 * q, 0]            # a tie
    d[4 * q:4 * q + 8] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2, 0, 1]]
    d[4 * q + 8:4 * q + 16] *= -1
    t_surf = np.zeros(n, np.float32)
    kind = rng.integers(0, 4, n)                     # none, before, in, behind
    t_surf[kind == 1] = rng.uniform(0.01, 0.2, (kind == 1).sum())
    t_surf[kind == 2] = rng.uniform(0.5, 3.0, (kind == 2).sum())
    t_surf[kind == 3] = rng.uniform(6.0, 9.0, (kind == 3).sum())
    return o, d, t_surf


def test_model_init_walk_equals_plain_on_odd_rays():
    """The init walk's form of the walk kernel on the clearance pyramid
    against the plain version bit for bit on rays with zero, tiny and
    negative direction components and surfaces before, inside and behind
    the box; and the advance from there."""
    _, tscene = _scenes(True)
    _, topts = _options("dist_mips")
    o, d, t_surf = _odd_rays()
    to, td, tts = (torch.as_tensor(x) for x in (o, d, t_surf))
    t0, t_start, a0 = trm.init_rays(
        tscene, to, td, tts, dataclasses.replace(topts, init_skip_iters=0))
    t, alive = mc.init_walk_reference(to, td, t0, tts, a0, tscene, topts)
    params, grid = mc._params(tscene, topts, iters=topts.init_skip_iters)
    box = _box(tscene)
    with np.errstate(all="ignore"):
        mt, ma = _model_init_walk(_P(params, grid), box, {
            "o": o, "d": d, "t": t0.numpy(), "t_surf": t_surf,
            "alive": a0.numpy()})
    _bits_equal(mt, t.numpy(), "init walk t")
    _bits_equal(ma, alive.numpy(), "init walk alive")
    assert (t.numpy() != t0.numpy()).sum() > len(t) // 4
    surf = np.zeros((len(o), 4), np.float32)
    surf[:, 3] = np.where(t_surf > 0, 1.0, 0.0)
    st = _state(o, d, surf, t_surf, t.numpy(), t_start.numpy(), alive.numpy())
    want = mc.advance_reference(_torch(st), tscene, topts, 48)
    params, grid = mc._params(tscene, topts, iters=48)
    with np.errstate(all="ignore"):
        got = _model_advance(_P(params, grid), box, st)
    _bits_equal(got[0], want[0].numpy(), "advance t")
    _bits_equal(got[1], want[1].numpy(), "advance alive")


def test_network_rows_in_either_order():
    """The network gives a row the same bits wherever it lies in the
    batch (its rows are independent): the composite may read the rows in
    slot order whatever order a caller evaluates them in."""
    net = params_from_jax(_np_params(init_params(jax.random.PRNGKey(2), JC1)),
                          _tcfg(JC1))
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.uniform(0, 1, (4099, 3)).astype(np.float32))
    dr = torch.as_tensor(rng.uniform(0, 1, (4099, 3)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(4099))
    for cdtype in (torch.float32, torch.bfloat16):
        rgb, sigma = net(p, dr, compute_dtype=cdtype)
        rgb_p, sigma_p = net(p[perm], dr[perm], compute_dtype=cdtype)
        _bits_equal(rgb_p.numpy(), rgb[perm].numpy(), "rgb")
        _bits_equal(sigma_p.contiguous().numpy(),
                    sigma[perm].contiguous().numpy(), "sigma")


def _advanced(route, surface):
    """The state after init and the advance pass (plain), numpy."""
    st, topts, tscene = _init_state(route, surface)
    t, alive = mc.advance_reference(_torch(st), tscene, topts, 48)
    return {**st, "t": t.numpy(), "alive": alive.numpy()}, topts, tscene


@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_model_samples_equal_plain(route, surface):
    st, topts, tscene = _advanced(route, surface)
    want = mc.samples_reference(_torch(st), tscene, topts)
    params, grid = mc._params(tscene, topts, skip_iters=topts.skip_iters,
                              steps=topts.steps_per_round)
    with np.errstate(all="ignore"):
        got = _model_samples(_P(params, grid), _box(tscene), st)
    for name, g, w in zip(("pos", "dt", "valid", "ts"), got[0], want[0]):
        _bits_equal(g, w.numpy(), name)
    for name, g, w in zip(("t_end", "exited", "surf_stopped"), got[1:],
                          want[1:]):
        _bits_equal(g, w.numpy(), name)
    assert want[0][2].any()


def _model_advance_samples(P, box, st):
    """The fused form: each ray's advance, then its K slots from the
    advanced t and alive."""
    t, alive = _model_advance(P, box, st)
    return (t, alive), _model_samples(P, box, {**st, "t": t, "alive": alive})


@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_model_fused_walk_equals_plain(route, surface):
    """The fused kernel's loop (the advance and then the first round's
    samples in one thread) equals advance_samples' CPU path bit for bit."""
    st, topts, tscene = _init_state(route, surface)
    (t, alive), want = mc.advance_samples(_torch(st), tscene, topts, 48)
    params, grid = mc._params(tscene, topts, iters=48,
                              skip_iters=topts.skip_iters,
                              steps=topts.steps_per_round)
    with np.errstate(all="ignore"):
        (mt, ma), got = _model_advance_samples(_P(params, grid), _box(tscene),
                                               st)
    _bits_equal(mt, t.numpy(), "t")
    _bits_equal(ma, alive.numpy(), "alive")
    for name, g, w in zip(("pos", "dt", "valid", "ts"), got[0], want[0]):
        _bits_equal(g, w.numpy(), name)
    for name, g, w in zip(("t_end", "exited", "surf_stopped"), got[1:],
                          want[1:]):
        _bits_equal(g, w.numpy(), name)
    assert want[0][2].any() and (t.numpy() != st["t"]).any()


@pytest.mark.parametrize("k", range(5))
def test_division_by_a_power_of_two_is_the_product_with_its_reciprocal(k):
    """x / 2^k == x * 2^-k bit for bit for float32 x over the normal
    range (numpy and torch on this CPU): the identity the kernels' probe
    relies on where it multiplies instead of dividing."""
    rng = np.random.default_rng(k)
    bits = rng.integers(0x00800000, 0x7F800000, 200000, dtype=np.int64)
    x = np.concatenate([bits, bits | 0x80000000]).astype(np.uint32)
    x = x.view(np.float32)
    s, inv = F(2.0 ** k), F(2.0 ** -k)
    assert mc._pow2_reciprocal(s) == inv
    _bits_equal(x / s, x * inv, "numpy")
    tx = torch.from_numpy(x)
    _bits_equal((tx / float(s)).numpy(), (tx * float(inv)).numpy(), "torch")
    _bits_equal((tx / float(s)).numpy(), x / s, "torch vs numpy")
    assert mc._pow2_reciprocal(F(3.0)) == 0 and mc._pow2_reciprocal(0.0) == 0


def _round_inputs(route, surface, seed=3, form="network"):
    """A state after the advance pass and a round's samples, with the
    network's rows seeded (raw density and colour for every valid slot,
    densities high enough on some slots that rays saturate; the density
    rows a column of an (M, 16) array, as the density MLP leaves them) or,
    with form "baked", a dense alpha and colour rows for a random part of
    the valid slots -> numpy (state, round)."""
    st, topts, tscene = _advanced(route, surface)
    (pos, dt, valid, ts), t_end, exited, stopped = mc.samples_reference(
        _torch(st), tscene, topts)
    rng = np.random.default_rng(seed)
    valid = (valid & torch.as_tensor(st["alive"])[None]).numpy()
    K, n = valid.shape
    rnd = {"t_end": t_end.numpy(), "exited": exited.numpy(),
           "surf_stopped": stopped.numpy(), "valid": valid, "ts": ts.numpy()}
    if form == "baked":
        alpha = rng.uniform(0, 1, (K, n)) ** 3
        alpha[rng.uniform(size=(K, n)) < 0.05] = 0.999
        rnd["alpha"] = np.where(valid, alpha, 0).astype(np.float32)
        rnd["color"] = valid & (rng.uniform(size=(K, n)) < 0.6)
        m = int(rnd["color"].sum())
    else:
        m = int(valid.sum())
        raw = rng.normal(0, 1, (m, 16)).astype(np.float32)
        raw[:, 0] = rng.uniform(-3, 9, m)
        raw[rng.uniform(size=m) < 0.05, 0] = 12.0
        rnd["sigma"], rnd["dt"] = raw[:, 0], dt.numpy()
    rnd["rgb"] = rng.normal(0, 2, (m, 3)).astype(np.float32)
    rnd["slots"] = np.nonzero(rnd.get("color", valid).reshape(-1))[0]
    return st, rnd, topts


def _composite_params(rnd, topts, code):
    cfg = topts.config
    return mc.MarchParams(
        steps=rnd["valid"].shape[0], deferred=topts.deferred_color,
        stage=code, density_act=mc.ACTIVATIONS[cfg.density_activation],
        rgb_act=(mc.ACT_EXP_CLAMPED if cfg.rgb_activation == "exponential"
                 else mc.ACTIVATIONS[cfg.rgb_activation]),
        sat_alpha=F(1 - topts.min_transmittance))


STAGES = {"all": mc.STAGE_BLEND | mc.STAGE_SAMPLES, "blend": mc.STAGE_BLEND,
          "samples": mc.STAGE_SAMPLES}


def _check_model_composite(st, rnd, topts, stage):
    code = STAGES[stage]
    want = mc.composite_reference(_torch(st), _torch(rnd), topts, code)
    P = _P(_composite_params(rnd, topts, code),
           torch.zeros(1, dtype=torch.uint8))
    got = _model_composite(P, st, rnd)
    for k in ("rgba", "depth", "max_weight", "wn", "surf_a", "alive"):
        _bits_equal(got[k], want[k].numpy(), k)
    # the blend fired, rays saturated and ended
    if code & mc.STAGE_BLEND:
        assert (got["surf_a"] != st["surf_a"]).any()
    if code & mc.STAGE_SAMPLES:
        assert (~got["alive"] & st["alive"]).any()
        assert (got["depth"] != st["depth"]).any()


@pytest.mark.parametrize("deferred", [False, True], ids=["colour", "deferred"])
@pytest.mark.parametrize("stage", ["all", "blend", "samples"])
@pytest.mark.parametrize("route", ["jump", "dist_mips"])
def test_model_composite_equals_plain(route, stage, deferred):
    """The composite kernel's loop on the network's rows (raw density and
    colour, activated in the kernel) equals the plain version bit for
    bit."""
    st, rnd, topts = _round_inputs(route, True)
    _check_model_composite(
        st, rnd, dataclasses.replace(topts, deferred_color=deferred), stage)


@pytest.mark.parametrize("deferred", [False, True], ids=["colour", "deferred"])
@pytest.mark.parametrize("stage", ["all", "blend", "samples"])
def test_model_composite_baked_form_equals_plain(stage, deferred):
    """The baked round's form: a dense alpha, colour rows on a part of
    the valid slots (the colour mask), the rest adding alpha alone."""
    st, rnd, topts = _round_inputs("dist_mips", True, form="baked")
    _check_model_composite(
        st, rnd, dataclasses.replace(topts, deferred_color=deferred), stage)


@pytest.mark.parametrize("kinds", [("relu", "exponential"), ("none", "relu"),
                                   ("logistic", "none")],
                         ids=["relu-exp", "none-relu", "logistic-none"])
def test_model_composite_takes_every_activation(kinds):
    """The kernel's activations of the density and the colour, each kind
    of ops/network.py, against the plain version's."""
    st, rnd, topts = _round_inputs("jump", True)
    cfg = dataclasses.replace(topts.config, density_activation=kinds[0],
                              rgb_activation=kinds[1])
    _check_model_composite(st, rnd, dataclasses.replace(topts, config=cfg),
                           "samples")


def _mismatched_rows(rnd, seed=5):
    """The network form's rows made not to match the valid mask: a tenth
    of the valid slots lose their row, 50 rows sit on slots outside the
    mask, the rows shuffled -> (those rows, the same with 4 more rows whose
    slots lie outside the round: K * n, K * n + 7, 2^40 and -1)."""
    rng = np.random.default_rng(seed)
    valid = rnd["valid"]
    m = len(rnd["slots"])
    keep = rng.uniform(size=m) >= 0.1
    extra = rng.choice(np.nonzero(~valid.reshape(-1))[0], 50, replace=False)
    slots = np.concatenate([rnd["slots"][keep], extra])
    sigma = np.concatenate([rnd["sigma"][keep],
                            rng.uniform(-3, 9, 50)]).astype(np.float32)
    rgb = np.concatenate([rnd["rgb"][keep],
                          rng.normal(0, 2, (50, 3))]).astype(np.float32)
    perm = rng.permutation(len(slots))
    inside = {**rnd, "slots": slots[perm], "sigma": sigma[perm],
              "rgb": rgb[perm]}
    outside = np.array([valid.size, valid.size + 7, 2 ** 40, -1])
    bad = {**inside,
           "slots": np.concatenate([inside["slots"], outside]),
           "sigma": np.concatenate([inside["sigma"],
                                    np.full(4, 5.0, np.float32)]),
           "rgb": np.concatenate([inside["rgb"],
                                  np.full((4, 3), 1.0, np.float32)])}
    return bad, inside


def test_model_composite_takes_rows_that_do_not_match_the_mask():
    """Rows that do not match the valid mask give the kernel a defined
    result: a valid slot with no row adds nothing (the plain version's
    zeros), a row on a slot outside the mask is not read, and one whose
    slot lies outside the round is left out, where the plain version
    raises."""
    st, rnd, topts = _round_inputs("jump", True)
    bad, inside = _mismatched_rows(rnd)
    code = STAGES["samples"]
    want = mc.composite_reference(_torch(st), _torch(inside), topts, code)
    P = _P(_composite_params(rnd, topts, code),
           torch.zeros(1, dtype=torch.uint8))
    for rows in (inside, bad):
        got = _model_composite(P, st, rows)
        for k in ("rgba", "depth", "max_weight", "wn", "surf_a", "alive"):
            _bits_equal(got[k], want[k].numpy(), k)
    assert not all(torch.equal(want[k], v) for k, v in mc.composite_reference(
        _torch(st), _torch(rnd), topts, code).items())
    with pytest.raises(IndexError):
        mc.composite_reference(_torch(st), _torch(
            {**bad, **{k: v[:-1] for k, v in bad.items()
                       if k in ("slots", "sigma", "rgb")}}), topts, code)


def _nan_on_last_slots(rnd):
    """rnd with the colour row of each ray's last valid slot set to NaN ->
    (that round, the rays planted)."""
    valid = rnd["valid"]
    K, n = valid.shape
    planted = valid.any(axis=0)
    last = K - 1 - np.argmax(valid[::-1], axis=0)
    slot = last * n + np.arange(n)
    rows = np.searchsorted(rnd["slots"], slot[planted])
    rgb = rnd["rgb"].copy()
    rgb[rows] = np.nan
    return {**rnd, "rgb": rgb}, planted


def test_model_composite_leaves_a_nan_row_on_an_unused_slot_alone():
    """The kernel's one departure from composite_reference: a NaN colour
    row on a slot its loop does not use (here the last valid slot of a
    ray that saturated before it) leaves the ray's colour as it was, where
    the plain version's 0 weight times NaN turns it to NaN; a NaN row on
    a slot the loop uses gives NaN in both, and every other ray is bit for
    bit the plain version's."""
    st, rnd, topts = _round_inputs("jump", True)
    code = STAGES["samples"]
    P = _P(_composite_params(rnd, topts, code),
           torch.zeros(1, dtype=torch.uint8))
    clean = _model_composite(P, st, rnd)
    nan_rnd, planted = _nan_on_last_slots(rnd)
    got = _model_composite(P, st, nan_rnd)
    want = mc.composite_reference(_torch(st), _torch(nan_rnd), topts, code)
    want_rgb = want["rgba"].numpy()[:, :3]
    assert np.isnan(want_rgb[planted]).all()
    nan_got = np.isnan(got["rgba"][:, :3]).any(axis=1)
    spared = planted & ~nan_got
    assert spared.any() and nan_got.any()
    _bits_equal(got["rgba"][spared], clean["rgba"][spared], "spared rays")
    assert np.isnan(got["rgba"][nan_got, :3]).all()
    _bits_equal(got["rgba"][~planted], want["rgba"].numpy()[~planted],
                "other rays")
    for k in ("depth", "max_weight", "wn", "surf_a", "alive"):
        _bits_equal(got[k], want[k].numpy(), k)


def _old_composite_reference(st, rnd, opts, stage):
    """The composite's plain version before the kernel read the network's
    rows: dense alpha (K, n) and rgb (K, n, 3), post-activation."""
    out = {k: st[k] for k in ("rgba", "depth", "max_weight", "wn", "surf_a",
                              "alive")}
    if stage & mc.STAGE_BLEND:
        out.update(mc.surface_blend_reference(st, rnd, opts))
    if not stage & mc.STAGE_SAMPLES:
        return out
    rgba, wn, comp_alive = out["rgba"], out["wn"], out["alive"]
    depth, max_w = out["depth"], out["max_weight"]
    valid = rnd["valid"] & st["alive"][None]
    alpha_k, rgb_s, ts = rnd["alpha"], rnd["rgb"], rnd["ts"]
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


def _aten_tail(rnd, opts):
    """The sequential round's steps between the network and the composite
    before the kernel read the rows: zero-filled dense alpha and colour,
    the dt gather, the activations and the alpha chain, two index_puts."""
    cfg = opts.config
    valid = rnd["valid"]
    K, n = valid.shape
    color = rnd.get("color", valid)
    sel = torch.nonzero(color.reshape(-1)).squeeze(1)
    rgb_s = torch.zeros((K, n, 3))
    if "alpha" in rnd:
        alpha_k = rnd["alpha"]
    else:
        alpha_k = torch.zeros((K, n))
        sigma = apply_density_activation(rnd["sigma"],
                                             cfg.density_activation)
        alpha_k.view(-1)[sel] = 1.0 - torch.exp(
            -sigma * rnd["dt"].reshape(-1)[sel])
    rgb_s.view(-1, 3)[sel] = apply_rgb_activation(rnd["rgb"],
                                                      cfg.rgb_activation)
    return {**rnd, "alpha": alpha_k, "rgb": rgb_s}


@pytest.mark.parametrize("form", ["network", "baked"])
@pytest.mark.parametrize("deferred", [False, True], ids=["colour", "deferred"])
@pytest.mark.parametrize("stage", ["all", "blend", "samples"])
def test_composite_reference_is_the_old_one_after_the_aten_tail(stage,
                                                                deferred,
                                                                form):
    """composite_reference on the network's rows equals, bit for bit, the
    former plain version on the dense alpha and colour that the round's
    aten ops made from the same rows."""
    st, rnd, topts = _round_inputs("dist_mips", True, form=form)
    topts = dataclasses.replace(topts, deferred_color=deferred)
    tst, trnd = _torch(st), _torch(rnd)
    want = _old_composite_reference(tst, _aten_tail(trnd, topts), topts,
                                    STAGES[stage])
    got = mc.composite_reference(tst, trnd, topts, STAGES[stage])
    for k in ("rgba", "depth", "max_weight", "wn", "surf_a", "alive"):
        _bits_equal(got[k].numpy(), want[k].numpy(), k)


# ---------------------------------------------------------------------------
# (c) The wrappers: dispatch, counters, validation, the contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors every wrapper returns its plain version's result and
    no launch is counted, through the frame's whole march too."""
    before = dict(mc.launches)
    st, topts, tscene = _advanced("dist_mips", True)
    tst = _torch(st)
    for got, want in ((mc.advance(tst, tscene, topts, 48),
                       mc.advance_reference(tst, tscene, topts, 48)),
                      (mc.samples(tst, tscene, topts)[1:],
                       mc.samples_reference(tst, tscene, topts)[1:])):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    (t, alive), fused = mc.advance_samples(tst, tscene, topts, 48)
    t2, alive2 = mc.advance_reference(tst, tscene, topts, 48)
    want = mc.samples_reference({**tst, "t": t2, "alive": alive2}, tscene,
                                topts)
    assert torch.equal(t, t2) and torch.equal(alive, alive2)
    assert all(torch.equal(g, w) for g, w in zip(fused[0] + fused[1:],
                                                  want[0] + want[1:]))
    st, rnd, topts = _round_inputs("jump", True)
    got = mc.composite(_torch(st), _torch(rnd), topts)
    want = mc.composite_reference(_torch(st), _torch(rnd), topts)
    assert all(torch.equal(got[k], want[k]) for k in want)
    o, d, surf, t_surf = (torch.as_tensor(x) for x in _rays(False, True))
    _, topts = _options("jump")
    _, tscene = _scenes(False)
    net = params_from_jax(_np_params(init_params(jax.random.PRNGKey(0), JC1)),
                          _tcfg(JC1))
    out, epochs = trm.march_frame_impl(net, tscene, o, d, surf, t_surf, topts)
    assert epochs > 1 and bool(torch.isfinite(out["rgba"]).all())
    assert mc.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    st, topts, tscene = _advanced("jump", True)
    tst = _torch(st)
    bad = [{**tst, "t": tst["t"].double()},                 # dtype
           {**tst, "alive": tst["alive"].to(torch.uint8)},   # mask dtype
           {**tst, "o": tst["o"][:, :2]},                    # shape
           {**tst, "surf_a": tst["surf_a"][:-1]},            # length
           {k: v.to("meta") for k, v in tst.items()}]        # device
    for b in bad:
        with pytest.raises(ValueError):
            mc.advance(b, tscene, topts, 4)
        with pytest.raises(ValueError):
            mc.samples(b, tscene, topts)
        with pytest.raises(ValueError):
            mc.advance_samples(b, tscene, topts, 4)
    with pytest.raises(ValueError):
        mc.init_walk(tst["o"], tst["d"], tst["t"][:, None], tst["t_surf"],
                     tst["alive"], tscene, topts)
    st, rnd, topts = _round_inputs("jump", False)
    trnd = _torch(rnd)
    for k, v in (("dt", trnd["dt"][:, :-1]), ("valid", trnd["dt"]),
                 ("rgb", trnd["rgb"][..., :2]), ("exited", trnd["t_end"]),
                 ("sigma", trnd["sigma"][:-1]), ("sigma", trnd["rgb"]),
                 ("ts", trnd["ts"].double()),
                 ("slots", trnd["slots"].int())):
        with pytest.raises(ValueError):
            mc.composite(_torch(st), {**trnd, k: v}, topts)
    st, rnd, topts = _round_inputs("jump", False, form="baked")
    trnd = _torch(rnd)
    for k, v in (("alpha", trnd["alpha"][:, :-1]), ("color", trnd["alpha"])):
        with pytest.raises(ValueError):
            mc.composite(_torch(st), {**trnd, k: v}, topts)


def test_compare_with_plain_counts_under_the_contract():
    n = 20000
    g = torch.Generator().manual_seed(0)
    t = torch.rand(n, generator=g) * 3
    alive = torch.rand(n, generator=g) < 0.7
    r = mc.compare_with_plain("walk", (t, alive), (t.clone(), alive.clone()))
    assert r["ok"] and r["mismatched_rays"] == 0 and r["allowed"] == 4
    step = torch.zeros(n)
    step[:3] = C.MIN_CONE_STEPSIZE
    r = mc.compare_with_plain("walk", (t + step, alive), (t, alive))
    assert r["ok"] and r["mismatched_rays"] == 3
    step[:3] = 2 * C.MAX_CONE_STEPSIZE          # beyond one step
    assert not mc.compare_with_plain("walk", (t + step, alive),
                                     (t, alive))["ok"]
    flip = alive.clone()
    flip[:5] = ~flip[:5]                         # more rays than allowed
    r = mc.compare_with_plain("walk", (t, flip), (t, alive))
    assert not r["ok"] and r["flag_mismatches"] == 5
    st, rnd, topts = _round_inputs("jump", True)
    out = mc.composite_reference(_torch(st), _torch(rnd), topts)
    near = {**out, "rgba": out["rgba"] + 5e-7}
    far = {**out, "depth": out["depth"] + 1e-5}
    assert mc.compare_with_plain("composite", near, out)["ok"]
    assert not mc.compare_with_plain("composite", far, out)["ok"]
    sm = mc.samples_reference(_torch(_advanced("dda", False)[0]),
                              *_advanced("dda", False)[2:0:-1])
    assert mc.compare_with_plain("samples", sm, sm)["mismatched_rays"] == 0


# ---------------------------------------------------------------------------
# (d) The kernels on the card
# ---------------------------------------------------------------------------

def _card(x):
    return {k: v.to("cuda") for k, v in x.items()}


def _card_scene(scene):
    return {k: v.to("cuda") for k, v in scene.items()}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_walk_and_sample_kernels_match_plain_on_card(route, surface):
    _needs_card()
    st, topts, tscene = _init_state(route, surface)
    cst, cscene = _card(_torch(st)), _card_scene(tscene)
    before = dict(mc.launches)
    out_k = mc.advance(cst, cscene, topts, 48)
    torch.cuda.synchronize()
    assert mc.launches["advance"] == before["advance"] + 1
    r = mc.compare_with_plain("walk", out_k,
                              mc.advance_reference(cst, cscene, topts, 48))
    assert r["ok"], r
    adv = {**cst, "t": out_k[0], "alive": out_k[1]}
    r = mc.compare_with_plain("samples", mc.samples(adv, cscene, topts),
                              mc.samples_reference(adv, cscene, topts))
    assert r["ok"], r
    o, d, t_surf = cst["o"], cst["d"], cst["t_surf"]
    t0, _, a0 = trm.init_rays(cscene, o, d, t_surf,
                              dataclasses.replace(topts, init_skip_iters=0))
    r = mc.compare_with_plain(
        "walk", mc.init_walk(o, d, t0, t_surf, a0, cscene, topts),
        mc.init_walk_reference(o, d, t0, t_surf, a0, cscene, topts))
    assert r["ok"], r
    assert mc.launches["samples"] == before["samples"] + 1
    assert mc.launches["init_walk"] == before["init_walk"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("deferred", [False, True], ids=["colour", "deferred"])
@pytest.mark.parametrize("stage", [3, 1, 2], ids=["all", "blend", "samples"])
def test_composite_kernel_matches_plain_on_card(stage, deferred):
    """The composite on the network's rows (the density rows a column of
    an (M, 16) tensor, as the density MLP leaves them) and in the baked
    form, against the plain version on the card."""
    _needs_card()
    for form in ("network", "baked"):
        st, rnd, topts = _round_inputs("dist_mips", True, form=form)
        topts = dataclasses.replace(topts, deferred_color=deferred)
        cst, crnd = _card(_torch(st)), _card(_torch(rnd))
        if form == "network":
            m = crnd["sigma"].shape[0]
            wide = torch.zeros((m, 16), device="cuda")
            wide[:, 0] = crnd["sigma"]
            crnd["sigma"] = wide[:, 0]
        before = mc.launches["composite"]
        got = mc.composite(cst, crnd, topts, stage)
        torch.cuda.synchronize()
        assert mc.launches["composite"] == before + 1
        r = mc.compare_with_plain(
            "composite", got, mc.composite_reference(cst, crnd, topts, stage))
        assert r["ok"], (form, r)


@pytest.mark.cuda
def test_composite_kernel_takes_rows_that_do_not_match_the_mask_on_card():
    """Rows that do not match the valid mask (_mismatched_rows: slots with
    no row, rows on slots outside the mask, rows whose slots lie outside
    the round) launch without a fault and give the plain version's result
    on the rows inside the round, under the contract; and a NaN colour
    row on a slot the loop does not use leaves the ray's colour as the
    clean round's."""
    _needs_card()
    st, rnd, topts = _round_inputs("jump", True)
    bad, inside = _mismatched_rows(rnd)
    cst = _card(_torch(st))
    code = STAGES["samples"]
    got = mc.composite(cst, _card(_torch(bad)), topts, code)
    torch.cuda.synchronize()
    r = mc.compare_with_plain("composite", got, mc.composite_reference(
        cst, _card(_torch(inside)), topts, code))
    assert r["ok"], r
    clean = mc.composite(cst, _card(_torch(rnd)), topts, code)
    nan_rnd, planted = _nan_on_last_slots(rnd)
    got = mc.composite(cst, _card(_torch(nan_rnd)), topts, code)
    torch.cuda.synchronize()
    nan_got = torch.isnan(got["rgba"][:, :3]).any(dim=1).cpu().numpy()
    spared = torch.as_tensor(planted & ~nan_got, device="cuda")
    assert bool(spared.any())
    assert torch.equal(got["rgba"][spared], clean["rgba"][spared])


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_fused_walk_equals_advance_then_samples_on_card(route, surface):
    """advance_samples in one launch equals advance followed by samples on
    the advanced rays, bit for bit, and holds under the contract against
    the plain versions on the card."""
    _needs_card()
    st, topts, tscene = _init_state(route, surface)
    cst, cscene = _card(_torch(st)), _card_scene(tscene)
    before = dict(mc.launches)
    (t, alive), got = mc.advance_samples(cst, cscene, topts, 48)
    torch.cuda.synchronize()
    assert mc.launches["advance_samples"] == before["advance_samples"] + 1
    t2, alive2 = mc.advance(cst, cscene, topts, 48)
    want = mc.samples({**cst, "t": t2, "alive": alive2}, cscene, topts)
    _bits_equal(t.cpu(), t2.cpu(), "t")
    _bits_equal(alive.cpu(), alive2.cpu(), "alive")
    for name, g, w in zip(("pos", "dt", "valid", "ts"), got[0], want[0]):
        _bits_equal(g.cpu(), w.cpu(), name)
    for name, g, w in zip(("t_end", "exited", "surf_stopped"), got[1:],
                          want[1:]):
        _bits_equal(g.cpu(), w.cpu(), name)
    t_p, alive_p = mc.advance_reference(cst, cscene, topts, 48)
    plain = mc.samples_reference({**cst, "t": t_p, "alive": alive_p}, cscene,
                                 topts)
    r = mc.compare_with_plain("advance_samples", ((t, alive), got),
                              ((t_p, alive_p), plain))
    assert r["ok"], r


@pytest.mark.cuda
def test_init_walk_kernel_matches_plain_on_odd_rays_on_card():
    """The init form of the walk kernel on rays with zero, tiny and
    negative direction components, on the clearance pyramid and the
    per-voxel DDA, against the card's plain version under the contract
    (not the CPU's bits: the pyramid's ladder takes log and exp, whose
    CPU and card versions round apart)."""
    _needs_card()
    _, tscene = _scenes(True)
    cscene = _card_scene(tscene)
    o, d, t_surf = (torch.as_tensor(x) for x in _odd_rays())
    for route in ("dist_mips", "dda"):
        _, topts = _options(route)
        t0, _, a0 = trm.init_rays(
            tscene, o, d, t_surf, dataclasses.replace(topts, init_skip_iters=0))
        args = [x.to("cuda") for x in (o, d, t0, t_surf, a0)]
        before = mc.launches["init_walk"]
        got = mc.init_walk(*args, cscene, topts)
        torch.cuda.synchronize()
        assert mc.launches["init_walk"] == before + 1
        r = mc.compare_with_plain("walk", got, mc.init_walk_reference(
            *args, cscene, topts))
        assert r["ok"], (route, r)


@pytest.mark.cuda
def test_card_divides_by_a_python_scalar_with_its_reciprocal():
    """The march's own quotients (the advance's (t_target - t) / dt_min on
    the jump-grid route, numerators made on the CPU) divided on the card by
    a Python float, by a float32 tensor on the card, and on the CPU: the
    tensor quotient is the CPU's, bit for bit; the Python-scalar quotient
    is the product with float32(1 / dt_min), and differs from the CPU's on
    some of them. The march kernels divide: on this route their advance
    gives the CPU plain version's bits."""
    _needs_card()
    st, topts, tscene = _init_state("jump", True)
    tst = _torch(st)
    pos = tst["o"] + tst["d"] * tst["t"][:, None]
    lv = tocc.skip_level_at(tscene["skip"], pos)
    res = C.NERF_GRIDSIZE * torch.exp2(-torch.clamp(lv, max=4).float())
    step = tocc.distance_to_next_voxel(pos, tst["d"], 1.0 / tst["d"], res)
    x = (tst["t"] + step) - tst["t"]
    s = C.MIN_CONE_STEPSIZE
    cpu = x / s
    xc = x.to("cuda")
    by_scalar = (xc / s).cpu()
    by_tensor = (xc / torch.tensor(s, dtype=torch.float32, device="cuda")).cpu()
    by_recip = (xc * (torch.tensor(1.0, device="cuda")
                      / torch.tensor(s, dtype=torch.float32,
                                     device="cuda"))).cpu()
    _bits_equal(by_tensor, cpu, "tensor divisor on the card vs CPU")
    _bits_equal(by_scalar, by_recip, "Python divisor vs reciprocal product")
    off = int((by_scalar != cpu).sum())
    ceil_off = int((torch.ceil(by_scalar) != torch.ceil(cpu)).sum())
    print(f"{off} of {x.numel()} quotients differ from the CPU's "
          f"({ceil_off} under the ceil)")
    assert off > 0
    cst, cscene = _card(tst), _card_scene(tscene)
    t_k, alive_k = mc.advance(cst, cscene, topts, 48)
    t_p, alive_p = mc.advance_reference(tst, tscene, topts, 48)
    _bits_equal(t_k.cpu(), t_p, "kernel advance vs CPU plain")
    _bits_equal(alive_k.cpu(), alive_p, "kernel alive vs CPU plain")


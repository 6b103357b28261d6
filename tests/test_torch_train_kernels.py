"""The training step's two kernels: the geometry pass
(ops/march_cuda.py::training_samples, nmr_training_samples in
csrc/march.cu) and the hash encode's gradient (ops/network_cuda.py::
hash_encode_backward and HashEncode, nmr_hash_encode_backward in
csrc/network.cu).

- training_samples_reference (the trainer's former loop) against the JAX
  package's march_training_samples, fed JAX's own `u`, on a sphere in
  cascade 0 and a shell in cascade 1 (tests/test_torch_train.py's grids),
  constant steps and cone steps.
- A numpy float32 model of the kernel's work for one ray (its hops, its
  sums in double as aten's CPU cumsum takes them, true divisions, the
  binary search) against the CPU plain version bit for bit, on the same
  grids and on rays that miss the aabb, start inside it or have zero
  direction components.
- hash_encode_backward_reference against autograd of the plain encode
  and against jax.vjp of the JAX package's hash_encode (table and
  position gradients, f32 and bf16); HashEncode on CPU tensors; the
  trainer's CPU step through the plain pieces.
- The wrappers' validation and launch counts, and (marked `cuda`, skipped
  without a card) each kernel against its plain version on the card. On
  the card: `JAX_PLATFORMS=cpu python -m pytest
  tests/test_torch_train_kernels.py -m cuda -q`.

Tolerances:
- the plain geometry pass against JAX: valid masks exact, t and dt to
  1e-5 (JAX's cumsum is an associative scan: its sums round apart);
- the model against the CPU plain version: bit for bit;
- the encode's table gradient: the plain version against autograd of
  the plain encode bit for bit (the same products, the same index_add_
  order); against JAX to 1e-6 of the largest magnitude at f32 (XLA's
  scatter-add sums each row in another order) and 1e-5 at bf16 (the
  same bf16 products, summed apart); the positions' gradient (summed
  over corners and levels in another order than autograd's) to 1e-6 of
  the largest magnitude against autograd, to 1e-5 at f32 and 1e-2 at
  bf16 against JAX, whose bf16 sum over the F products of a weight's
  gradient rounds apart by up to a bf16 step (2^-8);
- on the card: march_cuda.compare_training_samples' contract against the
  card's plain version (valid masks apart on at most 0.1% of the slots,
  t and dt to 1e-5 where both are valid) and bit for bit the CPU plain
  version; network_cuda.compare_gradients' (table and positions to 1e-5
  of their largest magnitudes: atomic adds in no fixed order, as the
  card's index_add_).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.ops import hashgrid as jhash
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.train import trainer as jtr
from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.io.dataset import ImageMetadata, NerfDataset
from nerf_glasses_tpu_torch.ops import hashgrid as thash
from nerf_glasses_tpu_torch.ops import march_cuda as mc
from nerf_glasses_tpu_torch.ops import network_cuda as nc
from nerf_glasses_tpu_torch.ops.network import init_params
from nerf_glasses_tpu_torch.train import trainer as ttr

torch.set_num_threads(1)

F32 = np.float32
G = C.NERF_GRIDSIZE
B, S, H = 96, 32, 128
CONE = 1.0 / 256.0
# small widths with dense and hashed levels (4 x 2 and 6 x 4)
ENC_CFGS = {"f2": JCfg(n_levels=4, log2_hashmap_size=9, base_resolution=4,
                       per_level_scale=2.0),
            "f4": JCfg(n_levels=6, n_features_per_level=4,
                       log2_hashmap_size=10, base_resolution=6,
                       per_level_scale=1.7)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _tcfg(jc):
    return TCfg(**{f: getattr(jc, f) for f in TCfg.__dataclass_fields__})


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")


# ---------------------------------------------------------------------------
# Scenes: occupancy grids and rays, made with numpy from a seed
# ---------------------------------------------------------------------------

def _sphere(radius, value=0.05):
    """(1, 128, 128, 128) density with a solid sphere at the centre
    (tests/helpers.make_sphere_density, made here: this file's `cuda`
    cases run where tests.helpers does not import)."""
    g = np.linspace(0, 1, G, endpoint=False) + 0.5 / G
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return (r < radius).astype(F32)[None] * F32(value)


def _scene(max_cascade, n=B, seed=0):
    """-> (occ (8, G, G, G) uint8, o, d (n, 3), aabb lo, hi (3,)) numpy:
    a sphere in cascade 0 (and a shell in cascade 1); rays from a sphere
    of radius 1.5 (2.4 with two cascades) around the centre toward
    jittered points near it; the first rays odd ones: one that misses the
    aabb, one from inside it, one along +z with two zero components, one
    on the aabb's face plane parallel to it (its slab test gives NaN)."""
    grid = _sphere(0.2)
    if max_cascade:
        grid = np.concatenate([grid, _sphere(0.45) - _sphere(0.35)])
    occ = np.asarray(jocc.build_occupancy(jnp.asarray(grid), max_cascade))
    half = 0.5 * (1 << max_cascade)
    lo = np.full(3, 0.5 - half, F32)
    hi = np.full(3, 0.5 + half, F32)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = 0.5 + (1.5 + 0.9 * max_cascade) * v
    tgt = 0.5 + rng.uniform(-0.25, 0.25, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[:4] = [[2.5, 2.5, 2.5], [0.5, 0.45, 0.55], [0.5, 0.5, -1.0],
             [lo[0], 0.4, -1.0]]
    d[:4] = [[1.0, 0.0, 0.0], [0.6, 0.0, 0.8], [0.0, 0.0, 1.0],
             [0.0, 0.0, 1.0]]
    return occ, o.astype(F32), d.astype(F32), lo, hi


# ---------------------------------------------------------------------------
# The numpy model of nmr_training_samples: one ray, the kernel's steps
# ---------------------------------------------------------------------------

def _nmin(a, b):
    return a if (a != a or a < b) else b


def _nmax(a, b):
    return a if (a != a or a > b) else b


def _lo(x, lo):
    return lo if x < lo else x


def _frexp_e(x):
    return int(np.frexp(F32(x))[1]) if np.isfinite(x) else 0


def _cell(q):
    v = F32(q * F32(G))
    return 0 if v != v else int(min(max(np.trunc(v), 0.0), G - 1))


def _calc_dt(t, cone):
    if cone == 0.0:
        return F32(C.MIN_CONE_STEPSIZE)
    x = _lo(F32(t * F32(cone)), F32(C.MIN_CONE_STEPSIZE))
    return F32(C.MAX_CONE_STEPSIZE) if x > F32(C.MAX_CONE_STEPSIZE) else x


def _mip_from_dt(dt, p, max_cascade):
    m = _nmax(_nmax(abs(p[0] - F32(0.5)), abs(p[1] - F32(0.5))),
              abs(p[2] - F32(0.5)))
    mip = min(max(_frexp_e(m) + 1, 0), max_cascade)
    x = F32(dt * F32(2 * G))
    return mip if x < F32(1.0) else min(max(_frexp_e(x), mip), max_cascade)


def _advance(t, cone, p, idir, half_s, mip):
    res, inv = F32(2.0 ** (7 - mip)), F32(2.0 ** (mip - 7))
    dist = F32(0)
    for i in range(3):
        x = F32(res * p[i])
        tt = F32((np.floor(F32(F32(x + F32(0.5)) + half_s[i])) - x) * idir[i])
        dist = tt if i == 0 else _nmin(dist, tt)
    target = F32(t + _lo(F32(dist * inv), F32(0)))
    if cone == 0.0:
        dmin = F32(C.MIN_CONE_STEPSIZE)
        n = _lo(F32(np.ceil(F32(F32(target - t) / dmin))), F32(1))
        return F32(t + F32(n * dmin))
    t1 = t
    for _ in range(8):
        if not t1 < target:
            break
        t1 = F32(t1 + _calc_dt(t1, cone))
    return _nmax(t1, F32(t + _calc_dt(t, cone)))


def _model_ray(occ, o, d, u, lo, hi, max_cascade, cone, hops):
    """One thread of training_samples_kernel -> (t, dt, valid) (S,)."""
    flat_occ = occ.reshape(-1)
    idir = [F32(F32(1) / d[c]) for c in range(3)]
    half_s = [F32(0.5) * F32((1.0 if d[c] > 0 else -1.0 if d[c] < 0 else 0.0)
                             + (1.0 if d[c] == 0 else 0.0)) for c in range(3)]
    tmin = tmax = F32(0)
    for c in range(3):
        ta = F32(F32(lo[c] - o[c]) * idir[c])
        tb = F32(F32(hi[c] - o[c]) * idir[c])
        a, b = _nmin(ta, tb), _nmax(ta, tb)
        tmin = a if c == 0 else _nmax(tmin, a)
        tmax = b if c == 0 else _nmin(tmax, b)
    if tmin > tmax:
        tmin = tmax = F32(np.finfo(F32).max)
    t0 = F32(_lo(tmin, F32(0)) + F32(1e-6))
    span = _lo(F32(tmax - t0), F32(0))
    stride = _lo(F32(span / F32(hops)), F32(1.0 / G))
    t, cum = t0, 0.0
    starts, cums, cums_ex = [], [], []
    for _ in range(hops):
        seg, t_next = F32(0), t
        if t < tmax:
            p = [F32(o[c] + F32(d[c] * t)) for c in range(3)]
            dt = _calc_dt(t, cone)
            mip = _mip_from_dt(dt, p, max_cascade)
            scale = F32(2.0 ** -mip)
            cc = [_cell(F32(F32(p[c] - F32(0.5)) * scale) + F32(0.5))
                  for c in range(3)]
            flat = ((mip * G + cc[2]) * G + cc[1]) * G + cc[0]
            if flat_occ[min(max(flat, 0), flat_occ.size - 1)]:
                seg = _nmin(stride, F32(tmax - t))
                t_next = F32(t + seg)
            else:
                t_next = _nmax(_advance(t, cone, p, idir, half_s, mip),
                               F32(t + F32(1e-6)))
        cum += float(seg)
        starts.append(t)
        cums.append(F32(cum))
        cums_ex.append(F32(F32(cum) - seg))
        t = t_next
    locc = cums[-1]
    dt_eff = F32(locc / F32(u.shape[0])) if locc > 0 else F32(1)
    out = np.zeros((3, u.shape[0]), F32)
    for k in range(u.shape[0]):
        s = F32(F32(F32(k) + u[k]) * dt_eff)
        a, b = 0, hops
        while a < b:
            mid = a + ((b - a) >> 1)
            if not cums[mid] > s:
                a = mid + 1
            else:
                b = mid
        h = min(a, hops - 1)
        valid = s < locc
        out[:, k] = [F32(starts[h] + F32(s - cums_ex[h])),
                     dt_eff if valid else F32(0), valid]
    return out


def _model(occ, o, d, u, lo, hi, max_cascade, cone, hops):
    with np.errstate(all="ignore"):
        rays = [_model_ray(occ, o[i], d[i], u[:, i], lo, hi, max_cascade,
                           cone, hops) for i in range(o.shape[0])]
    out = np.stack(rays, axis=-1)                     # (3, S, B)
    return {"t": out[0], "dt": out[1], "valid": out[2].astype(bool)}


def _bits(x):
    """float32 as its bits (every NaN as one: the sign and payload of a
    NaN differ between numpy, aten and the card), other dtypes as they
    are."""
    x = x.numpy() if torch.is_tensor(x) else x
    if x.dtype != F32:
        return x
    return np.where(np.isnan(x), F32(np.nan), x).view(np.int32)


def _plain(occ, o, d, u, lo, hi, max_cascade, cone, hops=H):
    return mc.training_samples_reference(_t(occ), _t(o), _t(d), _t(u),
                                         _t(lo), _t(hi), max_cascade, cone,
                                         hops)


CASES = {"sphere": (0, 0.0), "shell": (1, 0.0), "shell_cone": (1, CONE)}


# ---------------------------------------------------------------------------
# The plain geometry pass against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_training_samples_reference_matches_jax(case):
    max_cascade, cone = CASES[case]
    occ, o, d, lo, hi = _scene(max_cascade)
    jopts = jtr.TrainOptions(config=JCfg(aabb_scale=1 << max_cascade),
                             samples_per_ray=S, march_hops=H,
                             cone_angle=cone)
    key = jax.random.PRNGKey(7 + max_cascade)
    js = jtr.march_training_samples(jnp.asarray(occ), jnp.asarray(o),
                                    jnp.asarray(d), key, jopts,
                                    jnp.asarray(lo), jnp.asarray(hi),
                                    max_cascade)
    u = np.asarray(jax.random.uniform(key, (S, B)))
    ts = _plain(occ, o, d, u, lo, hi, max_cascade, cone)
    valid = np.asarray(js["valid"])
    np.testing.assert_array_equal(ts["valid"].numpy(), valid)
    assert 0.05 < valid.mean() and not valid[:, 0].any()
    np.testing.assert_allclose(ts["t"].numpy()[valid],
                               np.asarray(js["t"])[valid], atol=1e-5)
    np.testing.assert_allclose(ts["dt"].numpy(), np.asarray(js["dt"]),
                               atol=1e-5)


def test_trainer_routes_cpu_tensors_to_the_plain_version():
    """trainer.march_training_samples and the wrapper on CPU tensors give
    the plain version's bits and launch nothing."""
    occ, o, d, lo, hi = _scene(1)
    u = np.random.default_rng(1).uniform(0, 1, (S, B)).astype(F32)
    opts = ttr.TrainOptions(config=TCfg(aabb_scale=2), samples_per_ray=S,
                            march_hops=H, cone_angle=CONE)
    before = dict(mc.launches)
    got = ttr.march_training_samples(_t(occ), _t(o), _t(d), _t(u), opts,
                                     _t(lo), _t(hi), 1)
    want = _plain(occ, o, d, u, lo, hi, 1, CONE)
    assert mc.launches == before
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    with pytest.raises(ValueError, match="samples a ray"):
        ttr.march_training_samples(_t(occ), _t(o), _t(d), _t(u[:5]), opts,
                                   _t(lo), _t(hi), 1)


# ---------------------------------------------------------------------------
# The kernel's model against the CPU plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hops", [H, 24])
@pytest.mark.parametrize("case", list(CASES))
def test_model_is_the_cpu_plain_version_bit_for_bit(case, hops):
    """The numpy model of one kernel thread, rays 0-3 the odd ones: t, dt
    and valid bit for bit, hops 128 (the default) and 24 (too few to
    cross: the search's clamp to H - 1 and invalid samples' t)."""
    max_cascade, cone = CASES[case]
    occ, o, d, lo, hi = _scene(max_cascade, n=40, seed=3)
    u = np.random.default_rng(4).uniform(0, 1, (S, 40)).astype(F32)
    want = _plain(occ, o, d, u, lo, hi, max_cascade, cone, hops)
    got = _model(occ, o, d, u, lo, hi, max_cascade, cone, hops)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    v = want["valid"].numpy()
    assert v.any() and not v.all()
    assert not v[:, 0].any()                    # the ray that misses


def test_cpu_cumsum_sums_in_double():
    """The model's premise: aten's CPU cumsum of float32 accumulates in
    double and rounds each sum to float32."""
    x = np.random.default_rng(5).uniform(0, 0.01, (H, 64)).astype(F32)
    x[x < 0.005] = 0
    got = torch.cumsum(_t(x), 0).numpy()
    np.testing.assert_array_equal(got, np.cumsum(x.astype(np.float64),
                                                 0).astype(F32))


def test_training_samples_validation():
    occ, o, d, lo, hi = _scene(0, n=8)
    u = np.zeros((S, 8), F32)
    args = [_t(occ), _t(o), _t(d), _t(u), _t(lo), _t(hi)]

    def call(i=None, x=None, **kw):
        a = list(args)
        if i is not None:
            a[i] = x
        return mc.training_samples(*a, kw.get("mc", 0), kw.get("cone", 0.0),
                                   kw.get("hops", H))

    with pytest.raises(ValueError, match="o must"):
        call(1, _t(o).double())
    with pytest.raises(ValueError, match="d must"):
        call(2, _t(d)[:4])
    with pytest.raises(ValueError, match="u must"):
        call(3, _t(u)[:, :4])
    with pytest.raises(ValueError, match="occ must"):
        call(0, _t(occ).float())
    with pytest.raises(ValueError, match="aabb_min"):
        call(4, _t(lo)[:2])
    with pytest.raises(ValueError, match="hops"):
        call(hops=mc.MAX_TRAIN_HOPS + 1)
    with pytest.raises(ValueError, match="max_cascade"):
        call(mc=C.NERF_CASCADES)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        call(1, _t(o).to("meta"))
    out = call()
    assert out["t"].shape == (S, 8) and out["valid"].dtype == torch.bool


def test_training_samples_contract():
    occ, o, d, lo, hi = _scene(0, n=64)
    u = np.random.default_rng(6).uniform(0, 1, (S, 64)).astype(F32)
    p = _plain(occ, o, d, u, lo, hi, 0, 0.0)
    assert mc.compare_training_samples(p, p)["ok"]
    k = {key: v.clone() for key, v in p.items()}
    k["t"] = torch.where(k["valid"], k["t"] + 5e-6, k["t"])
    r = mc.compare_training_samples(k, p)
    assert r["ok"] and 4e-6 < r["max_t_err"] < 6e-6
    k["t"] = torch.where(k["valid"], k["t"] + 1e-4, k["t"])
    assert not mc.compare_training_samples(k, p)["ok"]
    k = {key: v.clone() for key, v in p.items()}
    flip = torch.zeros_like(k["valid"])
    flip.view(-1)[:3] = True             # 3 of 2,048 slots: past 0.1%
    k["valid"] = k["valid"] ^ flip
    r = mc.compare_training_samples(k, p)
    assert r["valid_mismatches"] == 3 and r["allowed"] == 2 and not r["ok"]


def test_training_samples_work_counts():
    _, o, _, _, _ = _scene(0, n=16)
    u = np.zeros((S, 16), F32)
    flops, nbytes = mc.training_samples_work(_t(o), _t(u), H)
    assert nbytes == 16 * 24 + S * 16 * 13 + 24
    assert flops == (12 + 2 * math.ceil(math.log2(H))) * S * 16


# ---------------------------------------------------------------------------
# The encode's gradient
# ---------------------------------------------------------------------------

def _enc_inputs(jc, n=257, seed=0):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((jc.n_levels, jhash.padded_table_rows(jc),
                                  jc.n_features_per_level)) * 0.5).astype(F32)
    pos = rng.uniform(0, 1, (n, 3)).astype(F32)
    pos[:3] = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.75]])[:n]
    g = rng.standard_normal((n, jc.n_levels * jc.n_features_per_level))
    return table, pos, g.astype(F32)


def _autograd(table, pos, g, cfg, dtype):
    tt = _t(table).requires_grad_(True)
    tp = _t(pos).requires_grad_(True)
    out = thash.hash_encode(tt, tp, cfg, compute_dtype=dtype)
    return torch.autograd.grad(out, [tt, tp], _t(g).to(dtype))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg", list(ENC_CFGS))
def test_backward_reference_is_autograd_of_the_plain_encode(cfg, dtype):
    jc, td = ENC_CFGS[cfg], DTYPES[dtype][0]
    table, pos, g = _enc_inputs(jc)
    gt, gp = _autograd(table, pos, g, _tcfg(jc), td)
    rt, rp = nc.hash_encode_backward_reference(_t(table), _t(pos),
                                               _t(g).to(td), _tcfg(jc), td,
                                               need_pos=True)
    np.testing.assert_array_equal(_bits(rt), _bits(gt))
    assert _rel(rp, gp) <= 1e-6
    rt2, rp2 = nc.hash_encode_backward_reference(_t(table), _t(pos),
                                                 _t(g).to(td), _tcfg(jc), td)
    assert rp2 is None and torch.equal(rt2, rt)
    S_rows = jhash.padded_table_rows(jc)
    for lvl, (_off, size, _res) in enumerate(_tcfg(jc).level_params()):
        if size < S_rows:                   # rows past the level stay 0
            assert not rt[lvl, size:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg", list(ENC_CFGS))
def test_backward_reference_matches_jax_vjp(cfg, dtype):
    jc = ENC_CFGS[cfg]
    td, jd = DTYPES[dtype]
    table, pos, g = _enc_inputs(jc, seed=1)
    _, vjp = jax.vjp(lambda t, p: jhash.hash_encode(t, p, jc,
                                                    compute_dtype=jd),
                     jnp.asarray(table), jnp.asarray(pos))
    jt, jp = vjp(jnp.asarray(g).astype(jd))
    rt, rp = nc.hash_encode_backward_reference(_t(table), _t(pos),
                                               _t(g).to(td), _tcfg(jc), td,
                                               need_pos=True)
    bf16 = dtype == "bfloat16"
    assert _rel(rt, np.asarray(jt)) <= (1e-5 if bf16 else 1e-6)
    assert _rel(rp, np.asarray(jp, np.float32)) <= (1e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hash_encode_function_on_cpu_is_the_plain_route(dtype):
    """HashEncode on CPU tensors: the plain encode's output and table
    gradient bit for bit, positions' gradient to 1e-6 of its largest
    magnitude, no launch."""
    jc, td = ENC_CFGS["f4"], DTYPES[dtype][0]
    cfg = _tcfg(jc)
    table, pos, g = _enc_inputs(jc, seed=2)
    tt = _t(table).requires_grad_(True)
    tp = _t(pos).requires_grad_(True)
    before = dict(nc.launches)
    out = nc.HashEncode.apply(tt, tp, cfg, td)
    want = thash.hash_encode(tt, tp, cfg, compute_dtype=td)
    assert out.dtype == td and torch.equal(out, want)
    gt, gp = torch.autograd.grad(out, [tt, tp], _t(g).to(td))
    wt, wp = _autograd(table, pos, g, cfg, td)
    np.testing.assert_array_equal(_bits(gt), _bits(wt))
    assert _rel(gp, wp) <= 1e-6
    (gt_only,) = torch.autograd.grad(nc.HashEncode.apply(tt, _t(pos), cfg,
                                                         td), [tt],
                                     _t(g).to(td))
    assert torch.equal(gt_only, gt) and nc.launches == before


def test_density_raw_on_cpu_takes_the_plain_route(monkeypatch):
    """A CPU call that needs gradients stays on the plain encode: no
    HashEncode, nothing counted on the card."""
    net = init_params(_tcfg(ENC_CFGS["f2"]), torch.Generator().manual_seed(0))
    net.requires_grad_(True)
    pos = torch.rand((50, 3), generator=torch.Generator().manual_seed(1))

    def forbidden(*a):
        raise AssertionError("HashEncode on a CPU tensor")

    monkeypatch.setattr(nc.HashEncode, "apply", forbidden)
    plain = dict(nc.plain_on_card)
    out = net.density_raw(pos, torch.bfloat16, torch.bfloat16)
    out.sum().backward()
    assert net.grid.grad is not None and nc.plain_on_card == plain
    assert not nc.trains_on_card(net.grid, pos)


def test_backward_validation_and_contract():
    jc = ENC_CFGS["f2"]
    cfg = _tcfg(jc)
    table, pos, g = _enc_inputs(jc, n=20)
    t, p = _t(table), _t(pos)
    with pytest.raises(ValueError, match="grad must"):
        nc.hash_encode_backward(t, p, _t(g), cfg, torch.bfloat16)
    with pytest.raises(ValueError, match="grad must"):
        nc.hash_encode_backward(t, p, _t(g)[:5], cfg)
    with pytest.raises(ValueError, match="grad must be contiguous"):
        nc.hash_encode_backward(t, p, _t(g).T.contiguous().T, cfg)
    with pytest.raises(ValueError, match="pos must"):
        nc.hash_encode_backward(t, p.double(), _t(g), cfg)
    before = dict(nc.launches)
    out = nc.hash_encode_backward(t, p, _t(g), cfg, need_pos=True)
    assert nc.launches == before
    r = nc.compare_gradients(out, out)
    assert r["ok"] and r["table"]["rel"] == 0.0 and r["pos"]["rel"] == 0.0
    bad = (out[0] + 2e-5 * out[0].abs().max(), out[1])
    assert not nc.compare_gradients(bad, out)["ok"]
    assert nc.compare_gradients((out[0], None), (out[0], None))["ok"]
    flops, nbytes = nc.encode_backward_work(t, p, cfg, need_pos=True)
    flops0, nbytes0 = nc.encode_backward_work(t, p, cfg)
    assert flops > flops0 > 0 and nbytes > nbytes0 > 20 * 12


# ---------------------------------------------------------------------------
# A training step on the CPU
# ---------------------------------------------------------------------------

def _dataset(n_img=2, w=24, seed=0):
    """Two noisy 24 x 24 images from cameras looking at the unit cube."""
    rng = np.random.default_rng(seed)
    ds = NerfDataset()
    ds.n_images = n_img
    ds.metadata = [ImageMetadata(resolution=(w, w), focal_length=(w, w),
                                 principal_point=(0.5, 0.5))
                   for _ in range(n_img)]
    xf = []
    for i in range(n_img):
        a = 0.4 * i
        rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                        [-math.sin(a), 0, math.cos(a)]])
        eye = 0.5 - 1.8 * rot[:, 2]
        xf.append(np.concatenate([rot, eye[:, None]], 1))
    ds.xforms = np.asarray(xf, F32)
    ds.xforms_end = ds.xforms.copy()
    ds.paths = [f"img_{i}" for i in range(n_img)]
    ds.images = [rng.uniform(0, 1, (w, w, 4)).astype(F32)
                 for _ in range(n_img)]
    return ds


def _opts(**kw):
    return ttr.TrainOptions(config=TCfg(n_levels=4, log2_hashmap_size=10,
                                        base_resolution=8), rays_per_batch=64,
                            samples_per_ray=16, **kw)


def test_cpu_training_step_is_the_plain_pieces(monkeypatch):
    """Two CPU steps (bf16 encode, compaction on) give the same loss,
    parameters and Adam moments bit for bit as the same steps with the
    geometry pass called as its plain version directly and HashEncode
    forbidden: the CPU step runs the plain versions as it did."""
    def run():
        tr = ttr.Trainer(_dataset(), _opts(), seed=5, device="cpu")
        tr.occ_warmup_steps = 0
        tr.train(2)
        return tr

    before = (dict(mc.launches), dict(nc.launches), dict(nc.plain_on_card))
    a = run()
    assert before == (dict(mc.launches), dict(nc.launches),
                      dict(nc.plain_on_card))

    def forbidden(*args):
        raise AssertionError("HashEncode on a CPU tensor")

    monkeypatch.setattr(mc, "training_samples",
                        lambda occ, o, d, u, lo, hi, m, cone, hops:
                        mc.training_samples_reference(occ, o, d, u, lo, hi,
                                                      m, cone, hops))
    monkeypatch.setattr(nc.HashEncode, "apply", forbidden)
    b = run()
    assert a.loss_history == b.loss_history
    for (name, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        np.testing.assert_array_equal(_bits(p.detach()), _bits(q.detach()),
                                      name)
    for k in ("m", "v"):
        for name in a.state["opt"][k]:
            assert torch.equal(a.state["opt"][k][name],
                               b.state["opt"][k][name])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hops", [H, 24])
@pytest.mark.parametrize("case", list(CASES))
def test_training_samples_on_card(case, hops):
    """The kernel bit for bit the CPU plain version, and under the
    contract against the card's plain version; one launch."""
    _card()
    max_cascade, cone = CASES[case]
    occ, o, d, lo, hi = _scene(max_cascade, n=2048, seed=8)
    u = np.random.default_rng(9).uniform(0, 1, (48, 2048)).astype(F32)
    args = [_t(x).cuda() for x in (occ, o, d, u, lo, hi)]
    n0 = mc.launches["training_samples"]
    got = mc.training_samples(*args, max_cascade, cone, hops)
    torch.cuda.synchronize()
    assert mc.launches["training_samples"] == n0 + 1
    cpu = _plain(occ, o, d, u, lo, hi, max_cascade, cone, hops)
    for k in cpu:
        np.testing.assert_array_equal(_bits(got[k].cpu()), _bits(cpu[k]), k)
    card = mc.training_samples_reference(*args, max_cascade, cone, hops)
    r = mc.compare_training_samples(got, card)
    assert r["ok"], r


@pytest.mark.cuda
def test_training_samples_on_card_edge_counts():
    _card()
    occ, o, d, lo, hi = _scene(0, n=33, seed=10)
    u = np.random.default_rng(11).uniform(0, 1, (5, 33)).astype(F32)
    for n in (0, 1, 33):
        args = [_t(x).cuda() for x in (occ, o[:n], d[:n], u[:, :n], lo, hi)]
        got = mc.training_samples(*args, 0, 0.0, mc.MAX_TRAIN_HOPS)
        cpu = _plain(occ, o[:n], d[:n], u[:, :n], lo, hi, 0, 0.0,
                     mc.MAX_TRAIN_HOPS)
        for k in cpu:
            np.testing.assert_array_equal(_bits(got[k].cpu()), _bits(cpu[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("need_pos", [False, True])
@pytest.mark.parametrize("n", [1, 65, 4099])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg", list(ENC_CFGS) + ["native_fast"])
def test_hash_encode_backward_on_card(cfg, dtype, n, need_pos):
    _card()
    jc = ENC_CFGS.get(cfg) or JCfg.native_fast()
    td = DTYPES[dtype][0]
    table, pos, g = _enc_inputs(jc, n=n, seed=12)
    args = (_t(table).cuda(), _t(pos).cuda(), _t(g).to(td).cuda(),
            _tcfg(jc), td, need_pos)
    n0 = nc.launches["hash_encode_backward"]
    got = nc.hash_encode_backward(*args)
    torch.cuda.synchronize()
    assert nc.launches["hash_encode_backward"] == n0 + 1
    want = nc.hash_encode_backward_reference(*args)
    r = nc.compare_gradients(got, want)
    assert r["ok"], r
    assert (got[1] is None) == (not need_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_training_forward_takes_the_encode_kernels_on_card(dtype):
    """density_raw on a network that trains: HashEncode's two kernels,
    then the MLP's (Mlp: nmr_mlp, nmr_mlp_backward), no plain version on
    the card; the table's gradient under the contract against the plain
    encode's through the same MLP kernels."""
    _card()
    td = DTYPES[dtype][0]
    cfg = TCfg.native_fast()
    net = init_params(cfg, torch.Generator().manual_seed(0)).cuda()
    net.requires_grad_(True)
    pos = torch.rand((5000, 3), generator=torch.Generator().manual_seed(1))
    pos = pos.cuda()
    nc.launches.update(dict.fromkeys(nc.launches, 0))
    nc.plain_on_card.update(dict.fromkeys(nc.plain_on_card, 0))
    out = net.density_raw(pos, torch.bfloat16, td)
    (grid_g,) = torch.autograd.grad(out[:, 0].sum(), [net.grid])
    torch.cuda.synchronize()
    assert nc.launches["hash_encode"] == 1
    assert nc.launches["hash_encode_backward"] == 1
    assert nc.plain_on_card["hash_encode"] == 0
    assert nc.plain_on_card["encode_mlp"] == 0
    assert nc.plain_on_card["mlp"] == 0
    assert nc.launches["mlp"] == nc.launches["mlp_backward"] == 1
    ref = thash.hash_encode(net.grid, pos, cfg, compute_dtype=td)
    want = nc.Mlp.apply(ref, torch.bfloat16, *net.density_mlp)
    (want_g,) = torch.autograd.grad(want[:, 0].sum(), [net.grid])
    assert nc.compare_gradients((grid_g, None), (want_g, None))["ok"]


@pytest.mark.cuda
def test_training_step_on_card_launches_both_kernels():
    """Three steps of a trainer on the card: one geometry-pass launch, one
    encode-forward and one encode-backward launch a step, no plain encode
    on the card."""
    _card()
    tr = ttr.Trainer(_dataset(), _opts(), seed=5, device="cuda")
    tr.occ_warmup_steps = 0
    tr.train(1)
    mc.launches.update(dict.fromkeys(mc.launches, 0))
    nc.launches.update(dict.fromkeys(nc.launches, 0))
    nc.plain_on_card.update(dict.fromkeys(nc.plain_on_card, 0))
    tr.train(3)
    torch.cuda.synchronize()
    assert mc.launches["training_samples"] == 3
    assert nc.launches["hash_encode"] == nc.launches["hash_encode_backward"] == 3
    assert nc.plain_on_card["hash_encode"] == nc.plain_on_card["encode_mlp"] == 0
    assert np.isfinite(tr.loss_history).all()

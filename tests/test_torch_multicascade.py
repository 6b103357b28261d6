"""Multi-cascade (aabb_scale > 1) building blocks of the PyTorch port
against the JAX package, on the same seeded inputs: the clearance grids,
the distance probes and the ladder jump, the per-cascade bake and its
samplers, the padded flash splat, and the march options.

Tolerances:
- clearance grids: integer, equal to the JAX grids and to scipy's
  chessboard distance transform.
- probes: the occupancy bit equal; the advanced t to rtol 1e-6. The
  ladder jump takes the ceil of a float32 log, so a ray whose quotient
  lands within roundoff of an integer may come out one rung apart: such
  rays are counted, held to 0.5% of the batch, and each to one step.
- bake_grids(mip, aabb): both packages run the density MLP in bfloat16
  (density_raw's default, which neither bake lets the caller change), so
  sigma is held to atol 1e-2 (raw, log space) and the features to one
  bfloat16 step, as tests/test_torch_bake.py holds the single-cascade
  bake; the masked cell set and the fill are exact, and the positions the
  network is fed are held to 1e-6 against the closed form in float32.
- samplers: rtol 1e-5 against the JAX brick sampler (the 8 corners summed
  in another order), 1e-6 against the per-cascade dense sampler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu import constants as C
from nerf_glasses_tpu.ops import bake as jbake
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.ops.network import init_params
from nerf_glasses_tpu_torch.ops import bake as tbake
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops.network import params_from_jax
from tests.test_multicascade import CFG4, make_cascaded_grid
from tests.test_torch_march import _np_params, _tcfg

torch.set_num_threads(1)

G = C.NERF_GRIDSIZE
CONE = 1.0 / 256.0
AABB4 = (np.full(3, -1.5, np.float32), np.full(3, 2.5, np.float32))


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.tensor(np.asarray(a))


def cascaded_occ(seed=0, speckle=0.0005):
    """The three-cascade fixture's occupancy plus seeded speckle on every
    cascade, pooled as build_occupancy pools it -> (8, G, G, G) uint8."""
    grid = make_cascaded_grid()
    rng = np.random.default_rng(seed)
    grid[rng.uniform(size=grid.shape) < speckle] = 0.05
    return np.asarray(jocc.build_occupancy(jnp.asarray(grid), 2))


# ---------------------------------------------------------------------------
# Clearance grids
# ---------------------------------------------------------------------------

def _oracle(level, cap=31):
    from scipy.ndimage import distance_transform_cdt
    return np.minimum(distance_transform_cdt(level == 0, metric="chessboard"),
                      cap)


def test_dist_grid_matches_jax_and_oracle():
    """tests/test_dist_advance.py's grid: sparse speckle and one blob."""
    rng = np.random.default_rng(4)
    occ = np.zeros((8, G, G, G), np.uint8)
    occ[0] = (rng.uniform(size=(G,) * 3) < 0.0005).astype(np.uint8)
    occ[0, 40:44, 60:64, 80:84] = 1
    got = tocc.build_dist_grid(T(occ), max_dist=31)
    assert got.dtype == torch.uint8 and got.shape == (G, G, G)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jocc.build_dist_grid(J(occ), max_dist=31)))
    np.testing.assert_array_equal(got.numpy(), _oracle(occ[0]))
    # a smaller cap and another level
    occ[3] = occ[0][::-1]
    np.testing.assert_array_equal(
        tocc.build_dist_grid(T(occ), max_dist=7, level=3).numpy(),
        np.asarray(jocc.build_dist_grid(J(occ), max_dist=7, level=3)))


def test_dist_grid_cascades_matches_jax_and_oracle():
    occ = cascaded_occ()
    got = tocc.build_dist_grid_cascades(T(occ), 2)
    assert got.dtype == torch.uint8 and got.shape == (3, G, G, G)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jocc.build_dist_grid_cascades(J(occ), 2)))
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), _oracle(occ[c]))
    assert (got == 0).sum() == (occ[:3] > 0).sum()


def test_dist_grid_is_zero_beyond_the_edges():
    """A voxel in one corner does not reach the opposite faces (the
    bake's occupancy mask wraps; the clearance grid must not)."""
    occ = np.zeros((8, G, G, G), np.uint8)
    occ[0, 0, 0, 0] = 1
    d = tocc.build_dist_grid(T(occ)).numpy()
    assert d[0, 0, 0] == 0 and d[0, 0, 5] == 5 and d[3, 9, 2] == 9
    assert d[-1, -1, -1] == 31 and d[0, 0, -1] == 31
    pos = np.array([[0.5 / G, 0.5 / G, 5.5 / G], [2.0, 2.0, 2.0],
                    [-1.0, 0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(
        tocc.dist_at(T(d), T(pos)).numpy(),
        np.asarray(jocc.dist_at_soa(J(d), *J(pos).T)))


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

def _rays(n=8192, seed=1, lo=-1.5, hi=2.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pos[: n // 4] = rng.uniform(0.0, 1.0, (n // 4, 3))     # mip 0
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:16, 1] = 0.0
    d[16:24, 0] = 0.0
    d[16:24, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 4.5, n).astype(np.float32)
    t[-64:] = rng.uniform(0.0, 0.5, 64)                    # below t1
    t_start = np.where(rng.uniform(size=n) < 0.5, 0.0,
                       t * rng.uniform(0, 1, n)).astype(np.float32)
    return pos, d, t, t_start


def _assert_advance(got, want, t, cone, max_share=0.005):
    """rtol 1e-6 but for a bounded share of rays one ladder step apart
    -> the number of such rays."""
    got, want = np.asarray(got), np.asarray(want)
    off = np.abs(got - want) > 1e-6 * np.maximum(np.abs(want), 1.0)
    step = np.asarray(jocc.calc_dt(J(np.maximum(got, want)), cone))
    assert (np.abs(got - want)[off] <= 1.01 * step[off]).all()
    assert off.sum() <= max_share * len(got), off.sum()
    assert (got > t).all()
    return int(off.sum())


def test_dist_probe_matches_jax():
    occ = cascaded_occ()
    dist = tocc.build_dist_grid(T(occ))
    pos, d, t, _ = _rays(lo=-0.1, hi=1.1)
    jo, ja = jrm._dist_probe({"dist": J(dist.numpy())}, J(pos), J(t), J(d))
    to, ta = trm._dist_probe({"dist": dist}, T(pos), T(t), T(d))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert 0 < to.sum() < len(pos)
    print("rays one lattice step apart:",
          _assert_advance(ta.numpy(), ja, t, 0.0))


@pytest.mark.parametrize("cone", [0.0, CONE], ids=["constant_dt", "cone"])
@pytest.mark.parametrize("min_mip", [0, 1])
def test_dist_probe_mips_matches_jax(cone, min_mip):
    occ = cascaded_occ()
    pyr = tocc.build_dist_grid_cascades(T(occ), 2)
    pos, d, t, t_start = _rays()
    dt = np.asarray(jocc.calc_dt(J(t - t_start), cone))
    jopts = jrm.MarchOptions(config=CFG4, cone_angle=cone, min_mip=min_mip)
    topts = trm.MarchOptions(config=_tcfg(CFG4), cone_angle=cone,
                             min_mip=min_mip)
    jo, ja = jrm._dist_probe_mips({"dist_mips": J(pyr.numpy())}, J(pos), J(t),
                                  J(d), J(dt), jopts)
    to, ta = trm._dist_probe_mips({"dist_mips": pyr}, T(pos), T(t), T(d),
                                  T(dt), topts)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert 0 < to.sum() < len(pos)
    # the bit is occupied_at's at the governing mip
    mip = torch.clamp(tocc.mip_from_dt(T(dt), T(pos), 2), min=min_mip)
    np.testing.assert_array_equal(
        to.numpy(), tocc.occupied_at(T(occ), T(pos), mip).numpy())
    print("rays one ladder step apart:",
          _assert_advance(ta.numpy(), ja, t, cone))


@pytest.mark.parametrize("cone", [0.0, CONE, 1.0 / 64.0])
def test_ladder_jump_matches_jax(cone):
    rng = np.random.default_rng(2)
    n = 20000
    t = rng.uniform(0.0, 6.0, n).astype(np.float32)
    if cone:
        # around the regime borders t1 = MIN / cone and t2 = MAX / cone
        t[:2000] = (C.MIN_CONE_STEPSIZE / cone
                    + rng.uniform(-0.01, 0.01, 2000)).astype(np.float32)
        t[2000:4000] = (C.MAX_CONE_STEPSIZE / cone
                        + rng.uniform(-2, 2, 2000)).astype(np.float32)
        t = np.abs(t)
    target = (t + rng.uniform(0.0, 1.0, n) ** 3 * 8.0).astype(np.float32)
    target[:50] = t[:50]                   # no distance: one step on
    got = trm._ladder_jump(T(t), T(target), cone).numpy()
    want = np.asarray(jrm._ladder_jump(J(t), J(target), cone))
    assert (got >= target - 1e-5 * np.maximum(target, 1)).all()
    print("rays one ladder step apart:", _assert_advance(got, want, t, cone))


def test_frexp_edge_values():
    """torch.frexp against jnp.frexp where the probes and mip_from_dt lean
    on it: 0, exact powers of two and their neighbours (no denormals: a
    step is never under MIN_CONE_STEPSIZE, and XLA's CPU flushes them)."""
    p2 = np.float32(2.0) ** np.arange(-20, 12, dtype=np.float32)
    x = np.concatenate([[0.0], p2, np.nextafter(p2, 0),
                        np.nextafter(p2, np.float32(1e9))]).astype(np.float32)
    jm, je = jnp.frexp(J(x))
    tm, te = torch.frexp(T(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the next power-of-two crossing of the cone step, as the probe
    # computes it, at those step sizes
    dt = np.clip(x, C.MIN_CONE_STEPSIZE, C.MAX_CONE_STEPSIZE)
    pos = np.full((len(x), 3), 0.5, np.float32)
    for mc in (0, 2, 5):
        np.testing.assert_array_equal(
            tocc.mip_from_dt(T(dt), T(pos), mc).numpy(),
            np.asarray(jocc.mip_from_dt(J(dt), J(pos), mc)))


@pytest.mark.parametrize("case", ["dist_single", "dist_multi", "min_mip",
                                  "dist_single_cone", "jump_grid"])
def test_skip_probe_branches_match_jax(case):
    """_skip_probe takes the JAX package's branch under each condition:
    the clearance grid on one cascade only with constant dt and no
    min_mip, the pyramid on several cascades, else the jump grid or the
    per-mip probe."""
    multi = case == "dist_multi"
    jc = CFG4 if multi else dataclasses.replace(CFG4, aabb_scale=1)
    kw = dict(dist_single=dict(dist_advance=True),
              dist_multi=dict(dist_advance=True, cone_angle=CONE),
              min_mip=dict(min_mip=1, dist_advance=True),
              dist_single_cone=dict(dist_advance=True, cone_angle=CONE),
              jump_grid=dict())[case]
    occ = cascaded_occ()
    box = (np.zeros(3), np.ones(3), np.eye(3), np.zeros(3), np.ones(3))
    js, ts = jrm.make_scene(occ, *box), trm.make_scene(occ, *box)
    js["dist"] = jocc.build_dist_grid(js["occ"])
    ts["dist"] = tocc.build_dist_grid(ts["occ"])
    js["dist_mips"] = jocc.build_dist_grid_cascades(js["occ"], 2)
    ts["dist_mips"] = tocc.build_dist_grid_cascades(ts["occ"], 2)
    pos, d, t, t_start = _rays(n=4096, lo=-1.5 if multi else -0.05,
                               hi=2.5 if multi else 1.05)
    cone = kw.get("cone_angle", 0.0)
    dt = np.asarray(jocc.calc_dt(J(t - t_start), cone))
    jo, ja = jrm._skip_probe(js, J(pos), J(t), J(d), 1.0 / J(d), J(dt),
                             jrm.MarchOptions(config=jc, **kw))
    to, ta = trm._skip_probe(ts, T(pos), T(t), T(d), 1.0 / T(d), T(dt),
                             trm.MarchOptions(config=_tcfg(jc), **kw))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _assert_advance(ta.numpy(), ja, t, cone)


def test_march_options_carry_the_jax_fields():
    """Every option of the port has the JAX default, so the JAX bundles
    pass through unchanged; the three new ones are there."""
    jd = {f.name: f.default for f in dataclasses.fields(jrm.MarchOptions)}
    td = {f.name: f.default for f in dataclasses.fields(trm.MarchOptions)}
    assert {"dist_advance", "min_mip", "rounds_per_epoch"} <= set(td)
    assert set(td) <= set(jd)
    for k in set(td) - {"config"}:
        assert td[k] == jd[k], k
    assert (td["dist_advance"], td["min_mip"], td["rounds_per_epoch"]) == (
        False, 0, 1)


# ---------------------------------------------------------------------------
# Bake
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """Seeded weights with a hash table large enough to vary over space
    -> (JAX params, port network) for the aabb_scale 4 config."""
    params = init_params(jax.random.PRNGKey(11), CFG4)
    params = {**params, "grid": params["grid"] * 1e4}
    return params, params_from_jax(_np_params(params), _tcfg(CFG4))


def test_params_from_jax_with_aabb_scale_4(nets):
    """per_level_scale and the level table follow the scale; the carried
    network answers as the JAX one does on points of the whole box."""
    from nerf_glasses_tpu.ops.network import apply_network
    params, net = nets
    tc = _tcfg(CFG4)
    assert tc.max_cascade == 2 and tc.level_params() == CFG4.level_params()
    assert tc.cone_angle_constant == CFG4.cone_angle_constant == CONE
    rng = np.random.default_rng(3)
    pos01 = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
    dir01 = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
    jr, js = apply_network(params, J(pos01), J(dir01), CFG4,
                           compute_dtype=jnp.float32)
    tr, ts = net(T(pos01), T(dir01), compute_dtype=torch.float32)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert np.asarray(js).std() > 1e-3


class _Recorder:
    """Stands in for a network: density_raw returns its input positions in
    the first three of 16 channels."""

    def __init__(self, net):
        self.grid, self.config = net.grid, net.config

    def density_raw(self, pos01):
        return torch.cat([pos01, torch.zeros(pos01.shape[0], 13)], -1)


@pytest.mark.parametrize("mip", [0, 1, 2])
def test_bake_cell_centres(nets, mip):
    """The positions the network is fed: cascade `mip`'s cell centres
    (gd - 0.5) * 2^mip + 0.5 in raw coordinates, normalised by the
    training aabb, in [x, y, z] order at [z, y, x] cells."""
    R = 8
    sig, feat = tbake.bake_grids(_Recorder(nets[1]), R, features=True,
                                 log_space=True, mip=mip, aabb=AABB4)
    gd = ((np.arange(R, dtype=np.float32) + 0.5) / R - 0.5) * 2 ** mip + 0.5
    want = (gd + 1.5) / 4.0
    f = feat.float().numpy().reshape(R, R, R, 16)
    np.testing.assert_allclose(sig.numpy(), np.broadcast_to(want, (R, R, R)),
                               atol=1e-6)      # channel 0 is x
    np.testing.assert_allclose(f[..., 1], np.broadcast_to(
        want[None, :, None], (R, R, R)), atol=4e-3)         # bfloat16
    np.testing.assert_allclose(f[..., 2], np.broadcast_to(
        want[:, None, None], (R, R, R)), atol=4e-3)


@pytest.mark.parametrize("mip", [0, 1, 2])
def test_bake_grids_mip_matches_jax(nets, mip):
    params, net = nets
    occ = cascaded_occ(speckle=0.0)
    R = 32
    jg, jf = jbake.bake_grids(params, CFG4, R, occ=occ, features=True,
                              log_space=True, mip=mip, aabb=AABB4)
    tg, tf = tbake.bake_grids(net, R, occ=T(occ), features=True,
                              log_space=True, mip=mip, aabb=AABB4)
    baked = tbake._occ_mask(T(occ), R, mip).numpy()
    np.testing.assert_array_equal(baked, jbake._occ_mask(occ, R, mip))
    assert (0 < baked.sum() < baked.size) or mip == 1
    assert (tg.numpy()[~baked] == tbake.LOG_SIGMA_PAD).all()
    assert (tf.float().numpy()[~baked.reshape(-1)] == 0).all()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-2)
    np.testing.assert_allclose(tf.float().numpy(),
                               np.asarray(jf.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("R,Rf", [(16, 16), (32, 16)],
                         ids=["same_resolution", "coarser_features"])
def test_bake_grids_cascades_matches_jax(nets, R, Rf):
    """The stacked pyramid against the JAX brick table read at every cell
    centre of every cascade, and the feature pyramid row for row."""
    params, net = nets
    occ = cascaded_occ(speckle=0.0)
    jpacked, jfeat, n_casc = jbake.bake_grids_cascades(
        params, CFG4, R, occ=occ, aabb=AABB4, features=True,
        feat_resolution=Rf)
    tsig, tfeat = tbake.bake_grids_cascades(
        net, R, occ=T(occ), aabb=AABB4, features=True, feat_resolution=Rf)
    assert n_casc == 3 and tsig.shape == (3, R, R, R)
    assert tsig.dtype == torch.float32
    assert tfeat.shape == (3 * Rf ** 3, 16) and tfeat.dtype == torch.bfloat16
    np.testing.assert_allclose(tfeat.float().numpy(),
                               np.asarray(jfeat.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    gd = (np.arange(R, dtype=np.float32) + 0.5) / R
    zz, yy, xx = np.meshgrid(gd, gd, gd, indexing="ij")
    for c in range(3):
        raw = (np.stack([xx, yy, zz], -1).reshape(-1, 3) - 0.5) * 2 ** c + 0.5
        want = np.asarray(jbake.sample_sigma_bricks_mip_soa(
            jpacked, 3, *J(raw.astype(np.float32)).T,
            jnp.full(len(raw), c, jnp.int32)))
        np.testing.assert_allclose(tsig[c].numpy().reshape(-1), want,
                                   atol=1e-2)
    # without features
    s2, f2 = tbake.bake_grids_cascades(net, R, occ=T(occ), aabb=AABB4)
    assert f2 is None and torch.equal(s2, tsig)


def _mip_points(n=4096, seed=5, n_casc=3):
    """Raw positions spread over each cascade's cube and a little beyond
    it (clipped by the samplers), with their mips."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    mip = rng.integers(0, n_casc, n).astype(np.int32)
    return pos, (pos - 0.5) * (2.0 ** mip[:, None]).astype(np.float32) + 0.5, mip


def test_sigma_mip_sampler_matches_jax():
    rng = np.random.default_rng(6)
    R = 16
    grids = rng.uniform(-5, 10, (3, R, R, R)).astype(np.float32)
    pos, raw, mip = _mip_points()
    got = tbake.sample_baked_sigma_mip(T(grids), T(raw), T(mip)).numpy()
    packed = jnp.concatenate([jbake.pack_sigma_bricks(g) for g in grids], 0)
    np.testing.assert_allclose(
        got, np.asarray(jbake.sample_sigma_bricks_mip_soa(
            packed, 3, *J(raw).T, J(mip))), rtol=1e-5, atol=1e-5)
    for c in range(3):
        sel = mip == c
        np.testing.assert_allclose(
            got[sel], tbake.sample_baked_sigma(T(grids[c]),
                                               T(pos[sel])).numpy(),
            rtol=1e-6, atol=1e-5)
    # (K, n, 3) batches as the march passes them
    got3 = tbake.sample_baked_sigma_mip(T(grids), T(raw.reshape(4, -1, 3)),
                                        T(mip.reshape(4, -1)))
    np.testing.assert_array_equal(got3.numpy().reshape(-1), got)


def test_feat_mip_sampler_matches_jax():
    rng = np.random.default_rng(7)
    R = 8
    feat = T(rng.uniform(-2, 2, (3 * R ** 3, 16)).astype(np.float32)
             ).bfloat16()
    pos, raw, mip = _mip_points(seed=8)
    got = tbake.sample_feat_grid_mip(feat, 3, T(raw), T(mip))
    want = jbake.sample_feat_grid_mip(
        jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16), 3, J(raw),
        J(mip))
    assert got.dtype == torch.float32 and got.shape == (4096, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_mip_samplers_index_in_int64():
    """mip * R^3 passes 2^31 at R = 1024: the flat indices are int64."""
    q, mip = tbake._cascade_local(T(np.full((2, 3), 2.4, np.float32)),
                                  T(np.array([2, 9], np.int32)), 3)
    assert mip.dtype == torch.int64 and mip.tolist() == [2, 2]
    idx, _ = tbake._trilinear_setup(q, 1024)
    flat = idx + (mip * 1024 ** 3)[..., None]
    assert flat.dtype == torch.int64
    assert int(flat.max()) == 3 * 1024 ** 3 - 1 - (1023 - 998) * (
        1024 ** 2 + 1024 + 1)


# ---------------------------------------------------------------------------
# Flash splat with the per-point depth pad
# ---------------------------------------------------------------------------

def _splat_points(occ):
    pts, pads = [], []
    for c in range(3):
        p = np.argwhere(occ[c] > 0).astype(np.float32)[:, ::-1]
        pts.append(((p + 0.5) / G - 0.5) * 2 ** c + 0.5)
        pads.append(np.full(len(p), np.sqrt(3.0) * 2 ** c / (2.0 * G),
                            np.float32))
    return (np.concatenate(pts).astype(np.float32), np.concatenate(pads))


@pytest.mark.parametrize("view", ["outside", "inside_cascade_1"])
def test_flash_init_with_pad_matches_jax(view):
    """The splat over every cascade's centres with the half-diagonal pad.
    "inside_cascade_1": the eye stands in cascade 1 between the sphere and
    the outer blob and looks at the blob; the sphere lies behind the eye
    and must leave the coarse grid untouched (qz > 1e-6)."""
    occ = cascaded_occ(speckle=0.0)
    pts, pads = _splat_points(occ)
    cam = np.zeros((3, 4), np.float32)
    cam[:, 0] = [0.4, 0, 0]
    cam[:, 1] = [0, -0.4, 0]
    if view == "outside":
        cam[:, 2], cam[:, 3] = [0, 0, 1], [0.0, 0.0, -1.6]
    else:
        cam[:, 2], cam[:, 3] = [0, 0, 1], [0.0, 0.0, 0.6]   # eye z = 1.1
    kw = dict(lowres_factor=8, use_baked_sigma=True)
    jt, ja = jrm.flash_init({"occ_pts": J(pts), "occ_pts_pad": J(pads)},
                            J(cam), 96, 64, jrm.MarchOptions(config=CFG4, **kw))
    tt, ta = trm.flash_init({"occ_pts": T(pts), "occ_pts_pad": T(pads)},
                            T(cam), 96, 64,
                            trm.MarchOptions(config=_tcfg(CFG4), **kw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-6)
    assert ta.any() and (view != "outside" or not ta.all())
    floor = tt[ta].min().item()
    if view == "outside":
        # the sphere's front at z = 0.3 from an eye at z = -1.1
        assert 1.2 < floor < 1.4
    else:
        # only the blob (front at z = 1.7) is ahead of an eye at z = 1.1
        assert 0.4 < floor < 0.6
    # without the pad the floors sit deeper by up to a half diagonal
    t0, _ = trm.flash_init({"occ_pts": T(pts)}, T(cam), 96, 64,
                           trm.MarchOptions(config=_tcfg(CFG4), **kw))
    gap = (t0 - tt)[ta]
    assert (gap > 0).all() and gap.max() <= np.sqrt(3.0) * 4 / (2 * G) + 1e-6

"""Training parity: the PyTorch port's trainer pieces against the JAX
package's train/trainer.py, fed the same inputs and the JAX package's
own jax.random draws.

Setup: the synthetic sphere of tests/test_training.py (2 images, 64x64)
and its tiny config, trained 40 steps by the JAX trainer at f32
(compute_dtype and encode_dtype "float32") so the network is not at its
initialisation; the port gets the same parameters through
params_from_jax.

Tolerances: integer results (pixel ids, valid masks, keep sets, sample
ids, occupancy) are exact. Sample distances t and dt are f32 sums whose
order differs (JAX's cumsum is an associative scan): atol 1e-5. The loss
is held to rtol 1e-5 and every gradient array to 1e-4 of its max |g|
(the scatter-add into the table sums in another order). Adam is held to
atol 1e-7, the grid refresh to rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.train import trainer as jtr
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.ops import network as tnet
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.train import trainer as ttr
from tests.helpers import make_sphere_density
from tests.test_training import TINY_CFG, TINY_OPTS, make_synth_dataset
from tests.test_torch_dataset import port_dataset

torch.set_num_threads(1)

B, S = 256, 32
JOPTS = dataclasses.replace(TINY_OPTS, rays_per_batch=B, samples_per_ray=S,
                            grid_samples_per_update=1 << 14)


def _tcfg(jc):
    return TCfg(**{f: getattr(jc, f) for f in TCfg.__dataclass_fields__})


def _topts(jopts, **kw):
    fields = {f.name: getattr(jopts, f.name)
              for f in dataclasses.fields(ttr.TrainOptions)}
    fields["config"] = _tcfg(jopts.config)
    fields.update(kw)
    return ttr.TrainOptions(**fields)


def _t(x):
    return torch.from_numpy(np.array(x))


def _params_np(p):
    return {"density_mlp": tuple(np.asarray(w) for w in p["density_mlp"]),
            "rgb_mlp": tuple(np.asarray(w) for w in p["rgb_mlp"]),
            "grid": np.asarray(p["grid"])}


def _grads_np(g):
    out = {"grid": np.asarray(g["grid"])}
    for i, w in enumerate(g["density_mlp"]):
        out[f"density_{i}"] = np.asarray(w)
    for i, w in enumerate(g["rgb_mlp"]):
        out[f"rgb_{i}"] = np.asarray(w)
    return out


@pytest.fixture(scope="module")
def setup():
    ds = make_synth_dataset(n_images=2)
    tr = jtr.Trainer(ds, JOPTS, seed=7)
    tr.train(40)
    state = tr.state
    net = tnet.params_from_jax(_params_np(state["params"]),
                               _tcfg(TINY_CFG)).requires_grad_(True)
    tstate = {"net": net, "aux": {},
              "aabb_min": _t(state["aabb_min"]),
              "aabb_max": _t(state["aabb_max"])}
    tdata = {k: _t(v) for k, v in tr.data.items()}
    return tr, tstate, tdata


def _port_samples(js):
    return {k: _t(v) for k, v in js.items()}


def _jax_batch(tr, key, opts):
    r1, r2, r3 = jax.random.split(key, 3)
    img, px, py, target, samples = jtr._ray_batch(
        tr.state, tr.data, r1, r2, opts.rays_per_batch, opts)
    bg = jax.random.uniform(r3, (opts.rays_per_batch, 3))
    return img, px, py, target, samples, bg


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _jax_pixel_draws(key, n, n_img, h, w):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ku, kv = jax.random.split(k4)
    return {"img": jax.random.randint(k1, (n,), 0, n_img),
            "px": jax.random.randint(k2, (n,), 0, w),
            "py": jax.random.randint(k3, (n,), 0, h),
            "u_cdf": jax.random.uniform(k4, (n,)),
            "ux": jax.random.uniform(ku, (n,)),
            "uy": jax.random.uniform(kv, (n,))}


@pytest.mark.parametrize("case", ["uniform", "map_warmup", "map_past_warmup"])
def test_sample_pixels(setup, case):
    """img, px, py and the target rgba exact. The error map holds
    multiples of 1/8 over 2 x 4 x 4 cells, so the CDF (with its 0.25 x
    mean floor) is exact in any summation order."""
    tr, _, tdata = setup
    n_img, h, w = tr.data["images"].shape[:3]
    opts = dataclasses.replace(JOPTS, error_map_resolution=4,
                               error_map_floor=0.25, error_map_warmup=10)
    key = jax.random.PRNGKey(11)
    em = None
    step = 0
    if case != "uniform":
        em = (np.random.default_rng(0).integers(1, 17, (n_img, 4, 4))
              / 8.0).astype(np.float32)
        step = 5 if case == "map_warmup" else 10
    jimg, jpx, jpy, jtarget = jtr._sample_pixels(
        key, tr.data, B, None if em is None else jnp.asarray(em), step, opts)
    draws = {k: _t(v) for k, v in
             _jax_pixel_draws(key, B, n_img, h, w).items()}
    timg, tpx, tpy, ttarget = ttr._sample_pixels(
        draws, tdata, None if em is None else _t(em), step, _topts(opts))
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(tpy.numpy(), np.asarray(jpy))
    np.testing.assert_array_equal(ttarget.numpy(), np.asarray(jtarget))
    if case == "map_past_warmup":
        assert not np.array_equal(np.asarray(jimg), draws["img"].numpy())


def test_error_map_update(setup):
    tr, _, _ = setup
    rng = np.random.default_rng(2)
    em = rng.uniform(0.5, 2.0, (2, 8, 8)).astype(np.float32)
    img = rng.integers(0, 2, B)
    px = rng.integers(0, 64, B)
    py = rng.integers(0, 64, B)
    err = rng.uniform(0, 1, B).astype(np.float32)
    js, jc = jtr._error_map_accum(jnp.asarray(em), jnp.asarray(img),
                                  jnp.asarray(px), jnp.asarray(py),
                                  jnp.asarray(err), 64, 64)
    ts, tc = ttr._error_map_accum(_t(em), _t(img), _t(px), _t(py), _t(err),
                                  64, 64)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jn = jtr._error_map_apply(jnp.asarray(em), js, jc, 0.1)
    tn = ttr._error_map_apply(_t(em), ts, tc, 0.1)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)


def test_gen_rays_lens_distortion(setup):
    """The iterative OpenCV undistortion, on made-up k1 k2 p1 p2."""
    tr, _, tdata = setup
    data = dict(tr.data)
    dist = np.array([[0.05, -0.02, 0.003, -0.002],
                     [-0.04, 0.01, -0.001, 0.002]], np.float32)
    data["dist"] = jnp.asarray(dist)
    tdata = dict(tdata, dist=_t(dist))
    rng = np.random.default_rng(3)
    img, px, py = rng.integers(0, 2, B), rng.integers(0, 64, B), \
        rng.integers(0, 64, B)
    for lens in (False, True):
        jo, jd = jtr._gen_rays(data, jnp.asarray(img), jnp.asarray(px),
                               jnp.asarray(py), {}, lens)
        to, td = ttr._gen_rays(tdata, _t(img), _t(px), _t(py), {}, lens)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("max_cascade", [0, 1])
def test_march_training_samples(setup, max_cascade):
    """From the JAX package's `u`, on an occupancy grid with a sphere in
    cascade 0 and a shell in cascade 1; rays from the training cameras
    (and, for two cascades, from outside the unit cube)."""
    tr, _, tdata = setup
    cfg = dataclasses.replace(TINY_CFG, aabb_scale=1 << max_cascade)
    opts = dataclasses.replace(JOPTS, config=cfg)
    grid = make_sphere_density(radius=0.2, value=0.05)
    if max_cascade:
        shell = make_sphere_density(radius=0.45, value=0.05)
        shell -= make_sphere_density(radius=0.35, value=0.05)
        grid = np.concatenate([grid, shell])
    occ = np.asarray(jocc.build_occupancy(jnp.asarray(grid), max_cascade))
    half = 0.5 * (1 << max_cascade)
    lo = np.full(3, 0.5 - half, np.float32)
    hi = np.full(3, 0.5 + half, np.float32)
    key = jax.random.PRNGKey(5 + max_cascade)
    k1, k2 = jax.random.split(key)
    img, px, py, _ = jtr._sample_pixels(k1, tr.data, B)
    o, d = jtr._gen_rays(tr.data, img, px, py, {}, False)
    if max_cascade:
        o = (o - 0.5) * 1.6 + 0.5
    js = jtr.march_training_samples(jnp.asarray(occ), o, d, k2, opts,
                                    jnp.asarray(lo), jnp.asarray(hi),
                                    max_cascade)
    u = jax.random.uniform(k2, (S, B))
    ts = ttr.march_training_samples(_t(occ), _t(o), _t(d), _t(u),
                                    _topts(opts), _t(lo), _t(hi),
                                    max_cascade)
    valid = np.asarray(js["valid"])
    np.testing.assert_array_equal(ts["valid"].numpy(), valid)
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_allclose(ts["t"].numpy()[valid],
                               np.asarray(js["t"])[valid], atol=1e-5)
    np.testing.assert_allclose(ts["dt"].numpy(), np.asarray(js["dt"]),
                               atol=1e-5)


def test_compact_sample_sel(setup):
    """keep exact, sel equal; the port also returns the keep count."""
    tr, tstate, tdata = setup
    opts = dataclasses.replace(JOPTS, compact_keep_fraction=1.0 / 3.0)
    img, px, py, _, samples, _ = _jax_batch(tr, jax.random.PRNGKey(21), opts)
    jsel, jkeep = jtr.compact_sample_sel(tr.state, tr.data, img, px, py,
                                         samples, opts)
    tsel, tkeep, n_keep = ttr.compact_sample_sel(
        tstate, tdata, _t(img), _t(px), _t(py), _port_samples(samples),
        _topts(opts))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert int(n_keep) == int(np.asarray(jkeep).sum())
    assert 0 < int(n_keep) < S * B


@pytest.mark.parametrize("mode", ["dense", "compacted"])
def test_loss_and_grads(setup, mode):
    """forward_rays + loss + gradients with depth supervision on, dense
    and compacted (a 1/3 bucket the keep set overflows on this dense
    grid, so the dropped deepest samples must match too)."""
    tr, tstate, tdata = setup
    opts = dataclasses.replace(
        JOPTS, compact_keep_fraction=0.0 if mode == "dense" else 1.0 / 3.0)
    depths = np.random.default_rng(4).uniform(0.5, 1.5, (2, 64, 64))
    depths[:, ::3] = 0.0                      # pixels without supervision
    depths = depths.astype(np.float32)
    data = dict(tr.data, depths=jnp.asarray(depths))
    img, px, py, target, samples, bg = _jax_batch(tr, jax.random.PRNGKey(9),
                                                  opts)
    (jloss, jerr), (jgrads, _) = jtr._loss_and_grads(
        tr.state, data, img, px, py, target, samples, bg, opts)
    tloss, terr, tgrads, taux_grads, n_keep = ttr._loss_and_grads(
        tstate, dict(tdata, depths=_t(depths)), _t(img), _t(px), _t(py),
        _t(target), _port_samples(samples), _t(bg), _topts(opts))
    assert (n_keep is None) == (mode == "dense") and taux_grads == {}
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-4,
                               atol=1e-7)
    jg = _grads_np(jgrads)
    assert set(jg) == set(tgrads)
    for k, g in jg.items():
        scale = float(np.abs(g).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(tgrads[k].numpy(), g, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("loss_type", ["l2", "l1", "relative_l2", "mape",
                                       "smape", "log_l1", "huber"])
def test_loss_menu(loss_type):
    rng = np.random.default_rng(6)
    pred = rng.uniform(-0.2, 1.2, (B, 3)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (B, 3)).astype(np.float32)
    opts = dataclasses.replace(JOPTS, loss_type=loss_type)
    jl = jtr._loss_fn(jnp.asarray(pred), jnp.asarray(target), opts)
    tl = ttr._loss_fn(_t(pred), _t(target), _topts(opts))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 2500])
def test_adam_update(setup, step):
    """Adam with l2_reg on the MLP weights only and ExponentialDecay
    (0.5 every 700 steps after 1000): atol 1e-7."""
    tr, _, _ = setup
    opts = dataclasses.replace(JOPTS, lr_decay=0.5, lr_decay_start=1000,
                               lr_decay_interval=700, l2_reg=1e-2)
    rng = np.random.default_rng(8)

    def like(p, lo=-1.0, hi=1.0):
        return jax.tree.map(lambda a: jnp.asarray(rng.uniform(
            lo, hi, a.shape).astype(np.float32)), p)

    params = like(tr.state["params"], -0.5, 0.5)
    grads = like(params, -1e-2, 1e-2)
    opt = {"m": like(params, -1e-3, 1e-3), "v": like(params, 0.0, 1e-4)}
    jp, jopt = jtr.adam_update(params, grads, opt, jnp.int32(step), opts)
    net = tnet.params_from_jax(_params_np(params), _tcfg(TINY_CFG))
    g = {k: _t(v) for k, v in _grads_np(grads).items()}
    topt = {k: {n: _t(v) for n, v in _grads_np(opt[k]).items()}
            for k in ("m", "v")}
    ttr.adam_update(net, g, topt, step, _topts(opts))
    for name, want in _grads_np(jp).items():
        np.testing.assert_allclose(getattr(net, name).detach().numpy(), want,
                                   rtol=0, atol=1e-7, err_msg=name)
    for k in ("m", "v"):
        for name, want in _grads_np(jopt[k]).items():
            np.testing.assert_allclose(topt[k][name].numpy(), want, rtol=0,
                                       atol=1e-9, err_msg=f"{k} {name}")


@pytest.mark.parametrize("rebuild_occ", [False, True])
def test_update_density_grid(setup, rebuild_occ):
    """From the JAX package's cascade, cell and jitter draws: grid rtol
    1e-6, occupancy exact."""
    tr, tstate, _ = setup
    state = dict(tr.state)
    grid0 = np.random.default_rng(1).uniform(
        0.0, 0.002, state["density_grid"].shape).astype(np.float32)
    state["density_grid"] = jnp.asarray(grid0)
    j = jtr._update_density_grid_body(state, JOPTS, rebuild_occ)
    _, r1a, r1b, r2 = jax.random.split(state["rng"], 4)
    M = JOPTS.grid_samples_per_update
    draws = {"casc": _t(jax.random.randint(r1a, (M,), 0, 1)),
             "cell": _t(jax.random.randint(r1b, (M, 3), 0, 128)),
             "jitter": _t(jax.random.uniform(r2, (M, 3)))}
    ts = dict(tstate, density_grid=_t(grid0), occ=_t(state["occ"]))
    ttr._update_density_grid_body(ts, _topts(JOPTS), draws, rebuild_occ)
    want = np.asarray(j["density_grid"])
    np.testing.assert_allclose(ts["density_grid"].numpy(), want, rtol=1e-6,
                               atol=0)
    assert (want != grid0 * 0.95).sum() > 1000
    np.testing.assert_array_equal(ts["occ"].numpy(), np.asarray(j["occ"]))


def test_grid_refresh_uses_the_training_encode_dtype(setup, monkeypatch):
    """The density-grid refresh queries the network with the training
    encode dtype, bf16 by default, as the JAX package does
    (trainer.py:91, :879-881): the pin of that shared choice. A bf16
    refresh lands within 5e-2 of the f32 one (relative to the field's
    mean) and is not identical to it."""
    _, tstate, _ = setup
    assert ttr.TrainOptions(config=TINY_CFG).encode_dtype == "bfloat16"
    assert jtr.TrainOptions(config=TINY_CFG).encode_dtype == "bfloat16"
    seen = []
    orig = tnet.hash_encode

    def spy(table, pos, config, compute_dtype=torch.float32):
        seen.append(compute_dtype)
        return orig(table, pos, config, compute_dtype)

    monkeypatch.setattr(tnet, "hash_encode", spy)
    gen = torch.Generator().manual_seed(0)
    draws = ttr.draw_grid_update(gen, 1 << 14, 1, "cpu")
    grids = {}
    for enc in ("bfloat16", "float32"):
        st = dict(tstate, density_grid=torch.zeros((1, 128, 128, 128)),
                  occ=torch.ones((8, 128, 128, 128), dtype=torch.uint8))
        opts = _topts(JOPTS, encode_dtype=enc)
        ttr._update_density_grid_body(st, opts, draws, rebuild_occ=False)
        grids[enc] = st["density_grid"].numpy()
    assert seen == [torch.bfloat16, torch.float32]
    f32, bf16 = grids["float32"], grids["bfloat16"]
    scale = float(np.abs(f32[f32 > 0]).mean())
    assert np.abs(f32 - bf16).max() / scale < 5e-2
    assert np.abs(f32 - bf16).max() > 0.0


# ---------------------------------------------------------------------------
# The port's Trainer
# ---------------------------------------------------------------------------

def _small_trainer(seed=5, **kw):
    opts = _topts(JOPTS, **kw)
    return ttr.Trainer(port_dataset(make_synth_dataset(n_images=2)), opts,
                       seed=seed, device="cpu")


def test_train_with_and_without_callback():
    """train(n) takes the same steps whether or not a callback reads
    each loss: parameters, grid and losses equal."""
    a, b = _small_trainer(), _small_trainer()
    a.train(20)
    seen = []
    b.train(20, callback=lambda s, l: seen.append((s, l)))
    assert a.step == b.step == 20
    assert [s for s, _ in seen] == list(range(1, 21))
    assert a.loss_history == b.loss_history == [l for _, l in seen]
    for (n, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(a.state["density_grid"], b.state["density_grid"])


def test_keep_set_overflow_is_counted():
    """A compacted step whose keep set outgrows the bucket counts the
    step and the dropped samples (the JAX package drops them silently).
    compact_T_eps = 0 keeps every valid sample, so the drop is the
    valid count past the bucket."""
    tr = _small_trainer(compact_keep_fraction=0.25, compact_T_eps=0.0)
    assert tr.keep_overflow == (0, 0)
    opts = tr.opts
    draws = ttr.draw_step(tr.gen, tr.state, tr.data, opts)
    with torch.no_grad():
        img, px, py, _ = ttr._sample_pixels(draws, tr.data, None, 0, opts)
        o, d = ttr._gen_rays(tr.data, img, px, py, {}, False)
        samples = ttr.march_training_samples(
            tr.state["occ"], o, d, draws["u"], opts, tr.state["aabb_min"],
            tr.state["aabb_max"], 0)
    n_valid = int(samples["valid"].sum())
    bucket = ttr.compact_bucket(B * S, 0.25)
    assert n_valid > bucket
    ttr._train_step_body(tr.state, tr.data, opts, draws)
    assert tr.keep_overflow == (1, n_valid - bucket)
    # a dense step leaves the counters alone
    dense = dataclasses.replace(opts, compact_keep_fraction=0.0)
    ttr._train_step_body(tr.state, tr.data, dense,
                         ttr.draw_step(tr.gen, tr.state, tr.data, dense))
    assert tr.keep_overflow == (1, n_valid - bucket)


# ---------------------------------------------------------------------------
# Trainable auxiliary models: one step against the JAX package's
# ---------------------------------------------------------------------------

N_EXTRA = 4
AUX_FIELDS = {"optimize_extrinsics": ("cam_rot", "cam_trans"),
              "optimize_distortion": ("distortion",),
              "train_envmap": ("envmap",),
              "optimize_exposure": ("exposure",),
              "latent_codes": ("extra_dims",)}


def aux_options(fields):
    """JOPTS with the aux models of `fields` on (latent_codes: a config
    with N_EXTRA latent dims)."""
    kw = {f: True for f in fields if f != "latent_codes"}
    cfg = (dataclasses.replace(TINY_CFG, n_extra_learnable_dims=N_EXTRA)
           if "latent_codes" in fields else TINY_CFG)
    return dataclasses.replace(JOPTS, config=cfg, **kw)


def aux_step_pair(setup, fields, seed=0):
    """One _train_step_body on each package from the same state and the
    JAX package's draws, with the aux models of `fields` on -> (JAX state
    after, JAX loss, port state after, port loss, port state before).

    The state is the setup trainer's after 40 steps, with seeded aux
    models and aux moments, and for latent codes an rgb MLP widened by
    seeded input columns. Every second moment is floored at 1e-8 on both
    sides: where v is 0, Adam's first update is lr * sign(g), so a
    gradient at the level of float noise would flip a whole step."""
    tr, _, tdata = setup
    opts = aux_options(fields)
    rng = np.random.default_rng(seed)
    n = tr.data["images"].shape[0]
    base = jtr.make_train_state(jax.random.PRNGKey(0), opts,
                                tr.state["aabb_min"], tr.state["aabb_max"],
                                n_images=n)

    def uni(lo, hi, shape):
        return jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32))

    init = {"cam_rot": (-0.02, 0.02), "cam_trans": (-0.02, 0.02),
            "distortion": (-0.01, 0.01), "envmap": (0.3, 0.7),
            "extra_dims": (-0.2, 0.2), "exposure": (-0.2, 0.2)}
    aux = {k: uni(*init[k], a.shape) for k, a in base["aux"].items()}
    if "exposure" in aux:
        aux["exposure"] = aux["exposure"] - jnp.mean(aux["exposure"], 0)
    aux_opt = {"m": {k: uni(-1e-4, 1e-4, a.shape) for k, a in aux.items()},
               "v": {k: uni(1e-7, 1e-6, a.shape) for k, a in aux.items()}}
    params, opt = tr.state["params"], tr.state["opt"]
    if "latent_codes" in fields:
        def widen(w, lo, hi):
            extra = rng.uniform(lo, hi, (w.shape[0], 16)).astype(np.float32)
            return jnp.concatenate([w, jnp.asarray(extra)], axis=1)

        params = dict(params, rgb_mlp=(widen(params["rgb_mlp"][0], -0.2, 0.2),)
                      + params["rgb_mlp"][1:])
        opt = {"m": dict(opt["m"], rgb_mlp=(widen(opt["m"]["rgb_mlp"][0],
                                                  -1e-4, 1e-4),)
                         + opt["m"]["rgb_mlp"][1:]),
               "v": dict(opt["v"], rgb_mlp=(widen(opt["v"]["rgb_mlp"][0],
                                                  1e-8, 1e-7),)
                         + opt["v"]["rgb_mlp"][1:])}
    opt = {"m": opt["m"],
           "v": jax.tree.map(lambda v: jnp.maximum(v, 1e-8), opt["v"])}
    jstate = dict(tr.state, params=params, opt=opt, aux=aux, aux_opt=aux_opt)

    tstate = {
        "net": tnet.params_from_jax(_params_np(params), _tcfg(opts.config)
                                    ).requires_grad_(True),
        "opt": {k: {name: _t(v) for name, v in _grads_np(opt[k]).items()}
                for k in ("m", "v")},
        "aux": {k: _t(a) for k, a in aux.items()},
        "aux_opt": {k: {name: _t(a) for name, a in aux_opt[k].items()}
                    for k in ("m", "v")},
        "step": int(jstate["step"]),
        "density_grid": _t(jstate["density_grid"]),
        "occ": _t(jstate["occ"]),
        "error_map": _t(jstate["error_map"]),
        "aabb_min": _t(jstate["aabb_min"]),
        "aabb_max": _t(jstate["aabb_max"]),
        "loss_ema": _t(jstate["loss_ema"]),
        "overflow_steps": torch.zeros((), dtype=torch.int64),
        "overflow_samples": torch.zeros((), dtype=torch.int64)}
    before = {"aux": dict(tstate["aux"]),
              "params": {k: p.detach().clone()
                         for k, p in tstate["net"].named_parameters()}}

    _, r1, r2, r3 = jax.random.split(jstate["rng"], 4)
    n_img, h, w = tr.data["images"].shape[:3]
    draws = {k: _t(v) for k, v in
             _jax_pixel_draws(r1, B, n_img, h, w).items()}
    draws["u"] = _t(jax.random.uniform(r2, (S, B)))
    draws["bg"] = _t(jax.random.uniform(r3, (B, 3)))
    jout, jloss = jax.jit(jtr._train_step_body, static_argnames="opts")(
        jstate, tr.data, opts=opts)
    tloss = ttr._train_step_body(tstate, tdata, _topts(opts), draws)
    return jout, jloss, tstate, tloss, before


def assert_step_matches(jout, jloss, tstate, tloss, before):
    """Loss to rtol 1e-5; every updated parameter and aux array to 1e-5
    of its max |value|; every aux array moved."""
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name, want in _grads_np(jout["params"]).items():
        got = getattr(tstate["net"], name).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert set(tstate["aux"]) == set(jout["aux"])
    for k, want in jout["aux"].items():
        want = np.asarray(want)
        got = tstate["aux"][k].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
        assert not np.array_equal(got, before["aux"][k].numpy()), k


@pytest.mark.parametrize("field", list(AUX_FIELDS))
def test_unported_aux_models_raise(setup, field):
    """Each trainable aux model alone (the five that raised before the
    port had them): one step matches the JAX package's, and its aux
    arrays are the ones the JAX package trains."""
    out = aux_step_pair(setup, [field])
    assert set(out[2]["aux"]) == set(AUX_FIELDS[field])
    assert_step_matches(*out)

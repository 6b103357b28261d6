"""The trainable auxiliary models of the PyTorch port's trainer against the
JAX package's train/trainer.py: per-image extrinsics offsets, the
distortion raster, the envmap, per-image exposure and latent codes.

Inputs come from numpy seeds and the JAX package's own draws, at float32
(TINY_OPTS: f32 MLPs and encode, no compaction) on the synthetic sphere
of tests/test_training.py.

- make_train_state's aux models and moments equal the JAX package's.
- _rotate_small in value and gradient at rv = 0 and at seeded rv,
  _bilinear2d, _sample_envmap_dir and _gen_rays with every aux model, in
  value and in the gradient of a seeded projection: 1e-6 (gradients: 1e-6
  of their max).
- _aux_adam_update on seeded state: 1e-7; the exposures come out
  re-centred to zero mean.
- One _train_step_body with every aux model on (the single-model steps
  are in tests/test_torch_train.py): loss rtol 1e-5, updated parameters
  and aux arrays 1e-5 of their max.
- optimized_xforms equals the JAX trainer's.
- Latent codes survive save_snapshot, Testbed.load_snapshot (the port's
  and the JAX package's) and Trainer.load_snapshot to 1e-2 (the snapshot
  stores float16); a Testbed with latent codes renders >= 50 dB from the
  JAX Testbed's frame, and the codes change the frame.
The JAX test's extrinsics-recovery run (500 steps of 1024 rays) takes
over 7 minutes on one CPU thread in the port and is not repeated here;
chip_smoke.py phase 29 trains the extrinsics at full width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.train import trainer as jtr
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.train import trainer as ttr
from tests.test_torch_dataset import port_dataset
from tests.test_torch_train import (B, N_EXTRA, _t, _topts, assert_step_matches,
                                    aux_options, aux_step_pair, setup)
from tests.helpers import TEST_CFG, write_test_snapshot
from tests.test_training import make_synth_dataset

torch.set_num_threads(1)

ALL = ["optimize_extrinsics", "optimize_distortion", "train_envmap",
       "optimize_exposure", "latent_codes"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaf(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)


def test_make_train_state_aux_equals_jax():
    opts = aux_options(ALL)
    j = jtr.make_train_state(jax.random.PRNGKey(0), opts, np.zeros(3),
                             np.ones(3), n_images=5)
    t = ttr.make_train_state(_topts(opts), np.zeros(3), np.ones(3), 5,
                             torch.Generator().manual_seed(0))
    assert set(t["aux"]) == set(j["aux"]) == {
        "cam_rot", "cam_trans", "distortion", "envmap", "extra_dims",
        "exposure"}
    for k, a in j["aux"].items():
        np.testing.assert_array_equal(_np(t["aux"][k]), np.asarray(a))
        for m in ("m", "v"):
            np.testing.assert_array_equal(_np(t["aux_opt"][m][k]),
                                          np.asarray(j["aux_opt"][m][k]))
    plain = ttr.make_train_state(_topts(aux_options([])), np.zeros(3),
                                 np.ones(3), 5, torch.Generator())
    assert plain["aux"] == {} and plain["aux_opt"] == {"m": {}, "v": {}}
    with pytest.raises(ValueError, match="image count"):
        ttr.make_aux(_topts(aux_options(["optimize_exposure"])), 0)


def _value_and_grad(fn_j, fn_t, args, seed=1):
    """fn(*args) on both packages and the gradient of <fn, proj> for a
    seeded proj with respect to every float argument."""
    out_j = fn_j(*[jnp.asarray(a) for a in args])
    proj = np.random.default_rng(seed).normal(size=np.shape(out_j)).astype(
        np.float32)
    fl = [i for i, a in enumerate(args) if np.asarray(a).dtype == np.float32]

    def scalar(*fa):
        full = [jnp.asarray(a) for a in args]
        for i, x in zip(fl, fa):
            full[i] = x
        return jnp.sum(fn_j(*full) * proj)

    g_j = jax.grad(scalar, argnums=tuple(range(len(fl))))(
        *[jnp.asarray(args[i]) for i in fl])
    targs = [_leaf(a) if i in fl else torch.from_numpy(np.asarray(a))
             for i, a in enumerate(args)]
    out_t = fn_t(*targs)
    g_t = torch.autograd.grad((out_t * torch.from_numpy(proj)).sum(),
                              [targs[i] for i in fl])
    return (np.asarray(out_j), _np(out_t), [np.asarray(g) for g in g_j],
            [_np(g) for g in g_t])


def _assert_close(oj, ot, gj, gt, atol=1e-6):
    np.testing.assert_allclose(ot, oj, rtol=0, atol=atol)
    for a, b in zip(gt, gj):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=atol * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("rv", ["zero", "seeded"])
def test_rotate_small(rv):
    rng = np.random.default_rng(3)
    r = (np.zeros((64, 3)) if rv == "zero"
         else rng.uniform(-0.3, 0.3, (64, 3))).astype(np.float32)
    if rv == "seeded":
        r[:4] *= 1e-5                  # the small-angle branch
    v = rng.normal(size=(64, 3)).astype(np.float32)
    oj, ot, gj, gt = _value_and_grad(jtr._rotate_small, ttr._rotate_small,
                                     [r, v])
    _assert_close(oj, ot, gj, gt)
    if rv == "zero":
        np.testing.assert_array_equal(ot, v)


def test_bilinear2d_and_envmap():
    rng = np.random.default_rng(4)
    grid = rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)
    u = np.concatenate([rng.uniform(-0.1, 1.1, 200), [0.0, 1.0]]).astype(
        np.float32)
    v = np.concatenate([rng.uniform(-0.1, 1.1, 200), [1.0, 0.0]]).astype(
        np.float32)
    _assert_close(*_value_and_grad(jtr._bilinear2d, ttr._bilinear2d,
                                   [grid, u, v]))
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _assert_close(*_value_and_grad(jtr._sample_envmap_dir,
                                   ttr._sample_envmap_dir, [grid, d]))


def test_gen_rays_with_aux(setup):
    """Every aux model that moves rays, with lens undistortion on: o and
    d, and the gradient of a seeded projection of both into the
    extrinsics offsets and the distortion raster."""
    tr, _, tdata = setup
    rng = np.random.default_rng(5)
    n = tr.data["images"].shape[0]
    aux = {"cam_rot": rng.uniform(-0.05, 0.05, (n, 3)),
           "cam_trans": rng.uniform(-0.05, 0.05, (n, 3)),
           "distortion": rng.uniform(-0.02, 0.02, (32, 32, 2))}
    aux = {k: a.astype(np.float32) for k, a in aux.items()}
    dist = np.array([[0.05, -0.02, 0.003, -0.002],
                     [-0.04, 0.01, -0.001, 0.002]], np.float32)
    data = dict(tr.data, dist=jnp.asarray(dist))
    tdata = dict(tdata, dist=_t(dist))
    img, px, py = (rng.integers(0, n, B), rng.integers(0, 64, B),
                   rng.integers(0, 64, B))
    proj = rng.normal(size=(2, B, 3)).astype(np.float32)
    keys = sorted(aux)

    def jfn(*vals):
        o, d = jtr._gen_rays(data, jnp.asarray(img), jnp.asarray(px),
                             jnp.asarray(py), dict(zip(keys, vals)), True)
        return jnp.sum(o * proj[0]) + jnp.sum(d * proj[1]), (o, d)

    (_, (jo, jd)), jg = jax.value_and_grad(
        jfn, argnums=tuple(range(len(keys))), has_aux=True)(
        *[jnp.asarray(aux[k]) for k in keys])
    leaves = {k: _leaf(aux[k]) for k in keys}
    to, td = ttr._gen_rays(tdata, _t(img), _t(px), _t(py), leaves, True)
    tg = torch.autograd.grad((to * _t(proj[0])).sum()
                             + (td * _t(proj[1])).sum(),
                             [leaves[k] for k in keys])
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=0, atol=1e-6)
    for k, a, b in zip(keys, tg, jg):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, k
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=k)


def test_aux_adam_update():
    """Per-model learning rates, the extrinsics L2 anchor and the
    exposure re-centring, on seeded aux, gradients and moments."""
    rng = np.random.default_rng(6)
    opts = dataclasses.replace(aux_options(ALL), extrinsics_l2_reg=0.3)
    base = jtr.make_train_state(jax.random.PRNGKey(0), opts, np.zeros(3),
                                np.ones(3), n_images=6)["aux"]

    def like(lo, hi):
        return {k: rng.uniform(lo, hi, a.shape).astype(np.float32)
                for k, a in base.items()}

    aux, grads = like(-0.5, 0.5), like(-1e-2, 1e-2)
    opt = {"m": like(-1e-3, 1e-3), "v": like(1e-8, 1e-4)}
    for step in (0, 700):
        ja, jopt = jtr._aux_adam_update(
            jax.tree.map(jnp.asarray, aux), jax.tree.map(jnp.asarray, grads),
            jax.tree.map(jnp.asarray, opt), jnp.int32(step), opts)
        ta, topt = ttr._aux_adam_update(
            {k: _t(a) for k, a in aux.items()},
            {k: _t(a) for k, a in grads.items()},
            {m: {k: _t(a) for k, a in opt[m].items()} for m in opt},
            step, _topts(opts))
        for k in aux:
            np.testing.assert_allclose(_np(ta[k]), np.asarray(ja[k]), rtol=0,
                                       atol=1e-7, err_msg=k)
            for m in ("m", "v"):
                np.testing.assert_allclose(_np(topt[m][k]),
                                           np.asarray(jopt[m][k]), rtol=0,
                                           atol=1e-9, err_msg=f"{m} {k}")
        np.testing.assert_allclose(_np(ta["exposure"]).mean(axis=0), 0.0,
                                   atol=1e-7)


def test_train_step_with_every_aux_model(setup):
    out = aux_step_pair(setup, ALL, seed=7)
    assert_step_matches(*out)
    exposure = out[2]["aux"]["exposure"].numpy()
    np.testing.assert_allclose(exposure.mean(axis=0), 0.0, atol=1e-7)


def _small_trainer(fields, seed=5):
    opts = _topts(aux_options(fields))
    return ttr.Trainer(port_dataset(make_synth_dataset(n_images=3)), opts,
                       seed=seed, device="cpu")


def test_optimized_xforms_equal_jax():
    ds = make_synth_dataset(n_images=3)
    opts = aux_options(["optimize_extrinsics"])
    jt = jtr.Trainer(ds, opts)
    tt = ttr.Trainer(port_dataset(ds), _topts(opts), device="cpu")
    np.testing.assert_array_equal(tt.optimized_xforms(), jt.optimized_xforms())
    rng = np.random.default_rng(8)
    rot = rng.uniform(-0.1, 0.1, (3, 3)).astype(np.float32)
    rot[1] = 0.0                                  # no rotation: skipped
    trans = rng.uniform(-0.05, 0.05, (3, 3)).astype(np.float32)
    jt.state = dict(jt.state, aux={"cam_rot": jnp.asarray(rot),
                                   "cam_trans": jnp.asarray(trans)})
    tt.state["aux"] = {"cam_rot": _t(rot), "cam_trans": _t(trans)}
    want = jt.optimized_xforms()
    np.testing.assert_allclose(tt.optimized_xforms(), want, rtol=0, atol=1e-7)
    assert not np.allclose(want, np.asarray(ds.xforms))
    assert ttr.Trainer(port_dataset(ds), _topts(aux_options([])),
                       device="cpu").optimized_xforms().shape == (3, 3, 4)


@pytest.fixture(scope="module")
def latent_snapshot(tmp_path_factory):
    """A port trainer with latent codes and a distortion raster, 20 steps,
    its codes replaced by seeded ones, saved -> (trainer, path, codes)."""
    tr = _small_trainer(["latent_codes", "optimize_distortion"])
    tr.train(20)
    codes = np.random.default_rng(9).uniform(-1.0, 1.0, (3, N_EXTRA)).astype(
        np.float32)
    tr.state["aux"] = dict(tr.state["aux"], extra_dims=_t(codes))
    path = str(tmp_path_factory.mktemp("latent") / "latent.msgpack")
    tr.save_snapshot(path)
    return tr, path, codes


def test_latent_codes_survive_the_snapshot(latent_snapshot):
    tr, path, codes = latent_snapshot
    tb = tr.to_testbed()
    np.testing.assert_array_equal(tb.extra_dims, codes[0])
    np.testing.assert_array_equal(tb.distortion_map,
                                  _np(tr.state["aux"]["distortion"]))
    for testbed in (TTestbed(device="cpu"), JTestbed()):
        testbed.load_snapshot(path)
        assert testbed.config.n_extra_learnable_dims == N_EXTRA
        np.testing.assert_allclose(np.asarray(testbed.extra_dims), codes[0],
                                   atol=1e-2)
    resumed = _small_trainer(["latent_codes"], seed=11)
    resumed.load_snapshot(path)
    got = _np(resumed.state["aux"]["extra_dims"])
    assert got.shape == codes.shape
    np.testing.assert_allclose(got, np.broadcast_to(codes[0], codes.shape),
                               atol=1e-2)
    resumed.train(1)                     # the broadcast codes train on
    assert np.isfinite(resumed.loss)


def test_latent_codes_render_as_in_jax(tmp_path):
    """The codes reach the colour head: a sphere snapshot whose config
    has latent dims (tests/helpers.py, random network) gets seeded codes
    on the port's Testbed, which saves it; loaded again, the exact frame
    is >= 50 dB from the JAX Testbed's frame of the same file, and other
    codes change it."""
    cfg = dataclasses.replace(TEST_CFG, n_extra_learnable_dims=N_EXTRA)
    first, path = str(tmp_path / "a.msgpack"), str(tmp_path / "b.msgpack")
    write_test_snapshot(first, cfg=cfg)
    tb = TTestbed(device="cpu")
    tb.load_snapshot(first)
    assert tb.extra_dims is None
    tb.extra_dims = np.random.default_rng(10).uniform(
        -2.0, 2.0, N_EXTRA).astype(np.float32)
    tb.save_snapshot(path)
    frames = []
    for tb in (JTestbed(), TTestbed(device="cpu")):
        tb.load_snapshot(path)
        tb.march_overrides = {"max_rounds": 96, "jitter": False,
                              "compute_dtype": "float32"}
        frames.append(np.asarray(tb.render(40, 32, spp=1, linear=True)))
    mse = float(np.mean((frames[0].astype(np.float64) - frames[1]) ** 2))
    assert mse == 0.0 or 10.0 * np.log10(1.0 / mse) >= 50.0, mse
    assert tb._scene()["extra_dims"].shape == (N_EXTRA,)
    tb.extra_dims = np.zeros(N_EXTRA, np.float32)
    other = tb.render(40, 32, spp=1, linear=True)
    assert np.abs(other - frames[1]).max() > 1e-3

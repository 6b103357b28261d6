"""Data parallelism of the PyTorch port (parallel/sharding.py on
torch.distributed) against the JAX package's shard_map, and the functions
it calls: march_rays, march_frame and the trainer's functional API.

Multi-rank cases run two gloo ranks on the CPU through run_on_mesh (a
FileStore in a temporary directory, one torch thread a rank, every call
bounded by its timeout); the rank bodies live in
tests/torch_parallel_workers.py, which imports no JAX. The JAX side runs
on its virtual CPU mesh, make_mesh(2).

Tolerances:
- march_rays and march_frame against JAX on tests/test_raymarch.py's and
  tests/test_march_frame.py's scenes: atol 1e-5 (float32 MLPs, no
  jitter; the two differ in summation order only).
- make_sharded_march and render_image_sharded at 2 ranks against JAX's
  make_mesh(2), on tests/test_parallel.py:24-56's cases, a shard that
  takes march_frame (N/2 a multiple of chunk) and a pixel count that 2
  does not divide: atol 1e-5; the two ranks' results bit for bit equal.
- render_hybrid_sharded at 2 ranks against JAX's make_mesh(2): atol 1e-4
  (tests/test_torch_sharded.py says why); against the port's own
  n_shards=1 frame: atol 1e-6; the occlusion asserts of
  tests/test_parallel.py:145-167.
- train_step, train_chunk (grid refresh + 2 steps) and _ray_batch
  against JAX from the JAX package's own draws: the bars of
  tests/test_torch_train.py::assert_step_matches (loss rtol 1e-5, every
  parameter 1e-5 of its max |value|), grid rtol 1e-6, occupancy exact.
- One data-parallel step (error map on and past its warmup; dense and
  compacted) against JAX's make_sharded_train_step(make_mesh(2)), each
  rank fed the draws JAX makes from fold_in(rng, rank): loss rtol 1e-5,
  parameters 1e-5 of their max |value|, error map and loss EMA rtol
  1e-5; every replicated tensor bit for bit equal on both ranks.
- tests/test_parallel.py's three ShardedTrainer tests at 2 ranks, with
  the replicas bit for bit equal after a chunk and at the end.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.ops import raymarch as jrm
from nerf_glasses_tpu.parallel import sharding as jsh
from nerf_glasses_tpu.train import trainer as jtr
from nerf_glasses_tpu.train.trainer import TrainOptions
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops.network import params_from_jax
from nerf_glasses_tpu_torch.parallel import sharding as tsh
from nerf_glasses_tpu_torch.train import trainer as ttr
from tests import torch_parallel_workers as workers
from tests.test_raymarch import CFG, OPTS, make_scene, zero_params
from tests.test_torch_dataset import port_dataset
from tests.test_torch_march import _np_params
from tests.test_torch_sharded import H, W, hybrid  # noqa: F401 (fixture)
from tests.test_torch_train import (B, JOPTS, S, _grads_np, _jax_pixel_draws,
                                    _params_np, _t, _tcfg, _topts,
                                    assert_step_matches, setup)  # noqa: F401
from tests.test_training import TINY_CFG, make_synth_dataset

torch.set_num_threads(1)

MARCH_ATOL = 1e-5
FRAME_ATOL = 1e-4
RANKS = 2
RANK_TIMEOUT_S = 240.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_scene(occ_full):
    occ = (np.ones if occ_full else np.zeros)((8, 128, 128, 128), np.uint8)
    return trm.make_scene(occ, np.zeros(3), np.ones(3), np.eye(3),
                          np.zeros(3), np.ones(3))


def _port_net():
    return params_from_jax(_np_params(zero_params()), _tcfg(CFG))


TOPTS = trm.MarchOptions(config=_tcfg(CFG), jitter=False,
                         compute_dtype="float32")


def _straight(n, surf=None, t_s=0.0):
    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (n, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    surf = np.zeros((n, 4), np.float32) if surf is None else \
        np.tile(np.asarray([surf], np.float32), (n, 1))
    return o, d, surf, np.full((n,), t_s, np.float32)


def _frame_rays(n=256):
    """tests/test_march_frame.py's rays and surfaces."""
    rng = np.random.default_rng(0)
    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (n, 1))
    o[:, :2] += rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    surf = np.zeros((n, 4), np.float32)
    tsurf = np.zeros((n,), np.float32)
    surf[::7] = [0.8, 0.1, 0.1, 1.0]
    tsurf[::7] = 1.6
    surf[1::7] = [0.2, 0.9, 0.2, 0.5]
    tsurf[1::7] = 1.4
    return o, d, surf, tsurf


# tests/test_raymarch.py's march_rays cases: (occupancy full, surface
# rgba or None, t_surface)
RAY_CASES = {"beer_lambert": (True, None, 0.0),
             "empty": (False, None, 0.0),
             "surface_only": (False, [0.9, 0.2, 0.1, 1.0], 1.5),
             "opaque_surface": (True, [1.0, 0.0, 0.0, 1.0], 1.4),
             "partial_surface": (True, [1.0, 1.0, 1.0, 0.5], 1.4)}


@pytest.mark.parametrize("case", list(RAY_CASES))
def test_march_rays_matches_jax(case):
    occ_full, surf, t_s = RAY_CASES[case]
    o, d, sf, ts = _straight(4, surf, t_s)
    want = jrm.march_rays(zero_params(), make_scene(occ_full), *map(
        jnp.asarray, (o, d, sf, ts)), OPTS)
    got = trm.march_rays(_port_net(), _port_scene(occ_full),
                         *map(torch.as_tensor, (o, d, sf, ts)), TOPTS)
    for k in ("rgba", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=MARCH_ATOL, err_msg=k)
    if case == "beer_lambert":
        np.testing.assert_allclose(got["rgba"][:, 3].numpy(),
                                   1.0 - np.exp(-1.0), atol=0.01)


def test_march_frame_matches_jax():
    """tests/test_march_frame.py's case (chunk 64, 2 rounds an epoch)
    through both packages' march_frame, and the port's against its own
    march_rays at that test's 1e-4; a ray count that is not a multiple
    of the chunk raises."""
    arrays = _frame_rays()
    fopts = dataclasses.replace(OPTS, chunk=64, rounds_per_epoch=2)
    want = jrm.march_frame(zero_params(), make_scene(True),
                           *map(jnp.asarray, arrays), fopts)
    topts = dataclasses.replace(TOPTS, chunk=64, rounds_per_epoch=2)
    t_in = [torch.as_tensor(a) for a in arrays]
    got = trm.march_frame(_port_net(), _port_scene(True), *t_in, topts)
    tiles = trm.march_rays(_port_net(), _port_scene(True), *t_in, TOPTS)
    for k in ("rgba", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=MARCH_ATOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), tiles[k].numpy(),
                                   atol=1e-4, err_msg=k)
    with pytest.raises(ValueError):
        trm.march_frame(_port_net(), _port_scene(True),
                        *[a[:100] for a in t_in], topts)


# ---------------------------------------------------------------------------
# Sharded rendering at 2 ranks
# ---------------------------------------------------------------------------

CAM = np.array([[1.1, 0.0, 0.0, 0.0],
                [0.0, 1.1, 0.0, 0.0],
                [0.0, 0.0, -1.0, 2.0]], np.float32)
IMAGE_SIZES = [(20, 12), (21, 11)]      # 240 pixels, and 231: padded


@pytest.fixture(scope="module")
def rendered(hybrid):  # noqa: F811
    """The JAX package's make_mesh(2) results and each port rank's, for
    the sharded march cases, the sharded images and the hybrid frame."""
    mesh2 = jsh.make_mesh(RANKS)
    straight = _straight(16)
    frame_rays = _frame_rays()
    fopts = dataclasses.replace(OPTS, chunk=64)
    jax_out = {"march": [], "image": []}
    for arrays, opts in ((straight, OPTS), (frame_rays, fopts)):
        fn = jsh.make_sharded_march(mesh2, opts)
        with mesh2:
            rgba, depth = fn(zero_params(), make_scene(True),
                             *map(jnp.asarray, arrays))
        jax_out["march"].append((np.asarray(rgba), np.asarray(depth)))
    for w, h in IMAGE_SIZES:
        jax_out["image"].append(jsh.render_image_sharded(
            zero_params(), make_scene(True), CAM, w, h, OPTS, mesh2))
    params, js, jm, jopts = hybrid["jax"]
    jax_out["hybrid"] = jsh.render_hybrid_sharded(
        params, js, jm, hybrid["xf"], hybrid["nm"], hybrid["cam"], W, H,
        jopts, mesh2)

    net, scene = _port_net(), _port_scene(True)
    marches = [(net, scene, *map(torch.as_tensor, arrays), opts)
               for arrays, opts in
               ((straight, TOPTS),
                (frame_rays, dataclasses.replace(TOPTS, chunk=64)))]
    images = [(net, scene, CAM, w, h, TOPTS) for w, h in IMAGE_SIZES]
    tnet, ts, tm, topts = hybrid["port"]
    hyb = (tnet, ts, tm, hybrid["xf"], hybrid["nm"], hybrid["cam"], W, H,
           topts)
    ranks = tsh.run_on_mesh(workers.render_jobs, RANKS, "gloo", "cpu",
                            marches, images, hyb, timeout=RANK_TIMEOUT_S)
    single = tsh.render_hybrid_sharded(tnet, ts, tm, hybrid["xf"],
                                       hybrid["nm"], hybrid["cam"], W, H,
                                       topts, n_shards=1)
    return jax_out, ranks, single


def _rank_equal(ranks, pick):
    for r in ranks[1:]:
        for a, b in zip(pick(ranks[0]), pick(r)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["straight_rays_march_rays",
                                  "frame_rays_march_frame"])
def test_sharded_march_matches_jax(rendered, case):
    i = ["straight_rays_march_rays", "frame_rays_march_frame"].index(case)
    jax_out, ranks, _ = rendered
    for k, (got, want) in enumerate(zip(ranks[0]["march"][i],
                                        jax_out["march"][i])):
        np.testing.assert_allclose(got, want, atol=MARCH_ATOL,
                                   err_msg=f"output {k}")
    _rank_equal(ranks, lambda r: r["march"][i])


@pytest.mark.parametrize("size", IMAGE_SIZES)
def test_render_image_sharded_matches_jax(rendered, size):
    i = IMAGE_SIZES.index(size)
    jax_out, ranks, _ = rendered
    rgba, depth = ranks[0]["image"][i]
    w, h = size
    assert rgba.shape == (h, w, 4) and depth.shape == (h, w)
    assert np.isfinite(rgba).all() and rgba[h // 2, w // 2, 3] > 0.5
    np.testing.assert_allclose(rgba, jax_out["image"][i][0], atol=MARCH_ATOL)
    np.testing.assert_allclose(depth, jax_out["image"][i][1],
                               atol=MARCH_ATOL)
    _rank_equal(ranks, lambda r: r["image"][i])


def test_render_hybrid_sharded_on_a_mesh(rendered):
    """Rank r renders band r; every rank returns the whole frame: equal
    to JAX's make_mesh(2) frame at 1e-4, to the port's one-process frame
    at 1e-6, and with tests/test_parallel.py:145-167's occlusion."""
    jax_out, ranks, single = rendered
    frame, depth = ranks[0]["hybrid"]
    assert frame.shape == (H, W, 4) and np.isfinite(frame).all()
    np.testing.assert_allclose(frame, jax_out["hybrid"][0], atol=FRAME_ATOL)
    np.testing.assert_allclose(depth, jax_out["hybrid"][1], atol=FRAME_ATOL)
    np.testing.assert_allclose(frame, single[0], atol=1e-6)
    np.testing.assert_allclose(depth, single[1], atol=1e-6)
    _rank_equal(ranks, lambda r: r["hybrid"])
    cy, cx = H // 2, W // 2
    assert frame[cy, cx, 3] > 0.9
    assert depth[cy, cx] == 0.0
    assert frame[cy, cx, 0] > frame[cy, cx, 1] + 0.05
    assert depth[cy, 40] > 0.5, depth[cy, 40]


def test_make_mesh_does_not_fall_back(rendered, hybrid):  # noqa: F811
    """nccl without a GPU raises, in a gloo group and outside any group;
    a mesh and n_shards together raise."""
    _, ranks, _ = rendered
    assert [r["nccl"] for r in ranks] == ["RuntimeError"] * RANKS
    with pytest.raises(RuntimeError):
        tsh.make_mesh()
    with pytest.raises(RuntimeError):
        tsh.make_mesh(backend="gloo", device="cpu")   # no group
    tnet, ts, tm, topts = hybrid["port"]
    mesh = tsh.Mesh(None, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError):
        tsh.render_hybrid_sharded(tnet, ts, tm, hybrid["xf"], hybrid["nm"],
                                  hybrid["cam"], W, H, topts, mesh,
                                  n_shards=2)


def test_run_on_mesh_ends_failed_and_late_ranks():
    with pytest.raises(RuntimeError, match="rank 1"):
        tsh.run_on_mesh(workers.fail_on_rank1, RANKS, "gloo", "cpu",
                        timeout=60.0)
    with pytest.raises(TimeoutError):
        tsh.run_on_mesh(workers.sleep, RANKS, "gloo", "cpu", 120.0,
                        timeout=8.0)


# ---------------------------------------------------------------------------
# The trainer's functional API against JAX
# ---------------------------------------------------------------------------

def _floored(js):
    """JAX state with every Adam second moment floored at 1e-8: where v is
    0, Adam's first update is lr * sign(g), and a gradient at the level
    of float noise would flip a whole step."""
    return dict(js, opt={"m": js["opt"]["m"], "v": jax.tree.map(
        lambda v: jnp.maximum(v, 1e-8), js["opt"]["v"])})


def _port_state(js, cfg):
    return {
        "net": params_from_jax(_params_np(js["params"]),
                               _tcfg(cfg)).requires_grad_(True),
        "opt": {k: {n: _t(v) for n, v in _grads_np(js["opt"][k]).items()}
                for k in ("m", "v")},
        "aux": {}, "aux_opt": {"m": {}, "v": {}},
        "step": int(js["step"]),
        "density_grid": _t(js["density_grid"]), "occ": _t(js["occ"]),
        "error_map": _t(js["error_map"]),
        "aabb_min": _t(js["aabb_min"]), "aabb_max": _t(js["aabb_max"]),
        "loss_ema": _t(js["loss_ema"]),
        "overflow_steps": torch.zeros((), dtype=torch.int64),
        "overflow_samples": torch.zeros((), dtype=torch.int64)}


def _step_draws(key, n, data, opts):
    """The draws of one JAX step from its (r1, r2, r3) split."""
    _, r1, r2, r3 = jax.random.split(key, 4)
    n_img, h, w = data["images"].shape[:3]
    d = {k: _t(v) for k, v in _jax_pixel_draws(r1, n, n_img, h, w).items()}
    d["u"] = _t(jax.random.uniform(r2, (opts.samples_per_ray, n)))
    d["bg"] = _t(jax.random.uniform(r3, (n, 3)))
    return d


def _before(ts):
    return {"aux": {}, "params": {k: p.detach().clone()
                                  for k, p in ts["net"].named_parameters()}}


def test_sample_rays_and_ray_batch_match_jax(setup):  # noqa: F811
    tr, tstate, tdata = setup
    key = jax.random.PRNGKey(31)
    jo, jd, jt = jtr._sample_rays(key, tr.data, B)
    n_img, h, w = tr.data["images"].shape[:3]
    draws = {k: _t(v) for k, v in
             _jax_pixel_draws(key, B, n_img, h, w).items()}
    to, td, tt = ttr._sample_rays(draws, tdata, B)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    with pytest.raises(ValueError):
        ttr._sample_rays(draws, tdata, B + 1)

    opts = dataclasses.replace(JOPTS, error_map_warmup=8)
    js = tr.state
    r1, r2 = jax.random.split(jax.random.PRNGKey(32))
    jimg, jpx, jpy, jtarget, jsamples = jtr._ray_batch(js, tr.data, r1, r2,
                                                       B, opts)
    draws = {k: _t(v) for k, v in
             _jax_pixel_draws(r1, B, n_img, h, w).items()}
    draws["u"] = _t(jax.random.uniform(r2, (S, B)))
    timg, tpx, tpy, ttarget, tsamples = ttr._ray_batch(
        _port_state(js, TINY_CFG), tdata, draws, B, _topts(opts))
    for a, b in ((timg, jimg), (tpx, jpx), (tpy, jpy), (ttarget, jtarget)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    valid = np.asarray(jsamples["valid"])
    np.testing.assert_array_equal(tsamples["valid"].numpy(), valid)
    np.testing.assert_allclose(tsamples["t"].numpy()[valid],
                               np.asarray(jsamples["t"])[valid], atol=1e-5)


def test_train_step_matches_jax(setup):  # noqa: F811
    tr, _, tdata = setup
    js = _floored(tr.state)
    ts = _port_state(js, TINY_CFG)
    before = _before(ts)
    draws = _step_draws(js["rng"], B, tr.data, JOPTS)
    jout, jloss = jtr.train_step(jax.tree.map(jnp.copy, js), tr.data, JOPTS)
    out, tloss = ttr.train_step(ts, tdata, _topts(JOPTS), draws)
    assert out is ts and ts["step"] == int(jout["step"])
    assert_step_matches(jout, jloss, ts, tloss, before)
    np.testing.assert_allclose(ts["error_map"].numpy(),
                               np.asarray(jout["error_map"]), rtol=1e-5,
                               atol=1e-9)


def test_train_chunk_matches_jax(setup):  # noqa: F811
    """The grid refresh at the top, then 2 steps, from the draws of the
    JAX package's rng chain; draws_fn is asked for them in that order."""
    tr, _, tdata = setup
    js = _floored(tr.state)
    ts = _port_state(js, TINY_CFG)
    before = _before(ts)
    M = JOPTS.grid_samples_per_update
    rng, r1a, r1b, r2 = jax.random.split(js["rng"], 4)
    queue = [("grid", {"casc": _t(jax.random.randint(r1a, (M,), 0, 1)),
                       "cell": _t(jax.random.randint(r1b, (M, 3), 0, 128)),
                       "jitter": _t(jax.random.uniform(r2, (M, 3)))})]
    for _ in range(2):
        queue.append(("step", _step_draws(rng, B, tr.data, JOPTS)))
        rng = jax.random.split(rng, 4)[0]
    asked = []

    def draws_fn(kind, opts):
        asked.append(kind)
        want, draws = queue.pop(0)
        assert kind == want and opts.rays_per_batch == B
        return draws

    jout, jlosses = jtr.train_chunk(jax.tree.map(jnp.copy, js), tr.data,
                                    JOPTS, 2, True, True)
    out, tlosses = ttr.train_chunk(ts, tdata, _topts(JOPTS), 2, True, True,
                                   draws_fn)
    assert out is ts and asked == ["grid", "step", "step"]
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    assert_step_matches(jout, jlosses[-1], ts, tlosses[-1], before)
    np.testing.assert_allclose(ts["density_grid"].numpy(),
                               np.asarray(jout["density_grid"]), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(ts["occ"].numpy(), np.asarray(jout["occ"]))


# ---------------------------------------------------------------------------
# One data-parallel step at 2 ranks against JAX's make_mesh(2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_steps(setup):  # noqa: F811
    """(JAX state and loss after one make_sharded_train_step, the port
    ranks' results) per mode; the error map sampled (warmup 8 < step 40)
    and updated."""
    tr, _, tdata = setup
    js = _floored(tr.state)
    mesh2 = jsh.make_mesh(RANKS)
    local = B // RANKS
    out, cases = {}, []
    for mode, frac in (("dense", 0.0), ("compacted", 1.0 / 3.0)):
        opts = dataclasses.replace(JOPTS, compact_keep_fraction=frac,
                                   error_map_warmup=8)
        with mesh2:
            jout, jloss = jsh.make_sharded_train_step(mesh2, opts)(
                jax.tree.map(jnp.copy, js), tr.data)
        draws = [_step_draws(jax.random.fold_in(js["rng"], r), local,
                             tr.data, opts) for r in range(RANKS)]
        cases.append((_port_state(js, TINY_CFG), tdata, _topts(opts),
                      draws))
        out[mode] = (jout, jloss)
    ranks = tsh.run_on_mesh(workers.dp_step, RANKS, "gloo", "cpu", cases,
                            timeout=RANK_TIMEOUT_S)
    return {mode: (*out[mode], [r[i] for r in ranks])
            for i, mode in enumerate(("dense", "compacted"))}


@pytest.mark.parametrize("mode", ["dense", "compacted"])
def test_data_parallel_step_matches_jax(dp_steps, mode):
    jout, jloss, ranks = dp_steps[mode]
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    for name, want in _grads_np(jout["params"]).items():
        np.testing.assert_allclose(got["params"][name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(got["error_map"],
                               np.asarray(jout["error_map"]), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(got["loss_ema"], float(jout["loss_ema"]),
                               rtol=1e-5)
    for r in ranks:
        assert r["mismatches"] == []
        assert r["loss"] == got["loss"] and r["overflow"] == got["overflow"]
    if mode == "dense":
        assert got["overflow"] == (0, 0)


# ---------------------------------------------------------------------------
# ShardedTrainer at 2 ranks (tests/test_parallel.py:59-75, :170-219)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainer_suite():
    plain = TrainOptions(config=TINY_CFG, rays_per_batch=512,
                         samples_per_ray=96, grid_samples_per_update=1 << 12,
                         cone_angle=1.0 / 64, compute_dtype="float32")
    compact = dataclasses.replace(plain, compact_keep_fraction=1.0 / 3.0)
    no_compact = TrainOptions(config=TINY_CFG, rays_per_batch=512,
                              samples_per_ray=32, compute_dtype="float32",
                              compact_keep_fraction=0.0)
    ds = port_dataset(make_synth_dataset(n_images=4))
    return tsh.run_on_mesh(workers.trainer_suite, RANKS, "gloo", "cpu", ds,
                           _topts(plain), _topts(compact),
                           _topts(no_compact), timeout=RANK_TIMEOUT_S)


def test_sharded_train_step_runs_and_decreases_loss(trainer_suite):
    for r in trainer_suite:
        p = r["plain"]
        assert p["step"] == 70
        assert np.isfinite(p["late"]).all()
        assert np.mean(p["late"]) < np.mean(p["early"]) * 0.8
    assert trainer_suite[0]["plain"] == trainer_suite[1]["plain"]


def test_sharded_trainer_compaction_warmup_gate(trainer_suite):
    for r in trainer_suite:
        c = r["compact"]
        assert c["gate"] == [True] * 4
        assert c["step"] == 68
        assert np.isfinite(c["late"]).all()
        assert np.mean(c["late"]) < np.mean(c["early"]) * 0.8
        assert c["mismatches"] == []


def test_sharded_trainer_no_compaction_shares_fns(trainer_suite):
    assert all(r["shares"] == (True, True) for r in trainer_suite)


def test_sharded_replicas_stay_bitwise_equal(trainer_suite):
    """After the first chunk and at the end every replicated tensor equals
    rank 0's bit for bit; the ranks drew from one grid seed and their own
    ray seeds; the callback path takes the chunked path's steps."""
    for r in trainer_suite:
        assert r["after_chunk"] == [] and r["plain"]["mismatches"] == []
        assert r["callback"] == {"steps": list(range(1, 7)), "losses": True,
                                 "params": True}
    grid_seeds = {r["seeds"][0] for r in trainer_suite}
    ray_seeds = {r["seeds"][1] for r in trainer_suite}
    assert len(grid_seeds) == 1 and len(ray_seeds) == RANKS


def test_parallel_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import nerf_glasses_tpu_torch.parallel.sharding, "
            "tests.torch_parallel_workers; "
            "assert not any(m == 'nerf_glasses_tpu' or "
            "m.startswith('nerf_glasses_tpu.') for m in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

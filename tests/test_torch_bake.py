"""Bake parity: the port's ops/bake.py and rgb_from_features against the
JAX package on the same inputs.

- bake_grids on the tests/helpers.py sphere snapshot (R = 32) and on
  trained_head_v6 (R = 64), occupancy-masked, in the activated and the
  log-space forms, with features. Both packages run the density MLP in
  bfloat16 (density_raw's default) with float32 sums taken in another
  order, so a hidden activation can round to the neighbouring bfloat16
  value: sigma is held to rtol 5e-3 (activated) or atol 1e-2 (raw), the
  features to one bfloat16 step (rtol 2^-7, atol 1e-2). The masked cell
  set and the empty-cell fill are exact.
- The dense sigma sampler against the JAX dense sampler (rtol 1e-6) and
  against the brick table the JAX march reads (pack_sigma_bricks +
  sample_sigma_bricks, rtol 1e-5: same trilinear weights, the 8 corners
  summed in another order); the feature sampler against the JAX one
  (atol 1e-6); both on random points inside and outside [0, 1]^3.
- rgb_from_features at float32 (atol 1e-5) and bfloat16 (atol 1e-3).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import bake as jbake
from nerf_glasses_tpu.ops.network import rgb_from_features
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import bake as tbake
from tests.helpers import write_test_snapshot

torch.set_num_threads(1)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "trained", "trained_head_v6.msgpack")


@pytest.fixture(scope="module")
def testbeds(tmp_path_factory):
    sphere = tmp_path_factory.mktemp("bake") / "sphere.msgpack"
    write_test_snapshot(sphere)
    out = {}
    for name, path in (("sphere", str(sphere)), ("trained", TRAINED)):
        j, t = JTestbed(), TTestbed(device="cpu")
        j.load_snapshot(path)
        t.load_snapshot(path)
        out[name] = (j, t)
    return out


@pytest.mark.parametrize("R", [32, 64, 96])
def test_occ_mask_matches_jax(testbeds, R):
    j, t = testbeds["trained"]
    want = jbake._occ_mask(np.asarray(j.occ), R)
    got = tbake._occ_mask(t.occ, R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("log_space", [False, True], ids=["activated", "log"])
@pytest.mark.parametrize("scene,R", [("sphere", 32), ("trained", 64)])
def test_bake_grids_matches_jax(testbeds, scene, R, log_space):
    j, t = testbeds[scene]
    jg, jf = jbake.bake_grids(j.params, j.config, R, occ=j.occ,
                              features=True, log_space=log_space)
    tg, tf = tbake.bake_grids(t.net, R, occ=t.occ, features=True,
                              log_space=log_space)
    jg = np.asarray(jg)
    jf = np.asarray(jf.astype(jnp.float32))
    assert tg.shape == (R, R, R) and tf.shape == (R ** 3, 16)
    assert tf.dtype == torch.bfloat16
    fill = tbake.LOG_SIGMA_PAD if log_space else 0.0
    baked = tbake._occ_mask(t.occ, R).numpy()
    assert (tg.numpy()[~baked] == fill).all() and (jg[~baked] == fill).all()
    assert (tf.float().numpy()[~baked.reshape(-1)] == 0).all()
    if log_space:
        np.testing.assert_allclose(tg.numpy(), jg, atol=1e-2)
    else:
        np.testing.assert_allclose(tg.numpy(), jg, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(tf.float().numpy(), jf, rtol=2 ** -7,
                               atol=1e-2)


def test_bake_grids_unmasked_matches_jax(testbeds):
    """Without occupancy every cell is evaluated; no features."""
    j, t = testbeds["sphere"]
    jg, jf = jbake.bake_grids(j.params, j.config, 16)
    tg, tf = tbake.bake_grids(t.net, 16)
    assert jf is None and tf is None
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=5e-3,
                               atol=1e-6)


def _points(n=4096, seed=5):
    """Random positions, some outside [0, 1]^3 (clipped by the samplers)."""
    return np.random.default_rng(seed).uniform(-0.1, 1.1, (n, 3)).astype(
        np.float32)


def test_sigma_sampler_matches_jax():
    rng = np.random.default_rng(6)
    grid = rng.uniform(-5, 10, (32, 32, 32)).astype(np.float32)
    pos = _points()
    got = tbake.sample_baked_sigma(torch.as_tensor(grid),
                                   torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jbake.sample_baked_sigma(jnp.asarray(grid),
                                                 jnp.asarray(pos))),
        rtol=1e-6, atol=1e-6)
    bricks = jbake.pack_sigma_bricks(grid)
    np.testing.assert_allclose(
        got, np.asarray(jbake.sample_sigma_bricks(bricks, jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)
    # (K, n, 3) batches as the march passes them
    got3 = tbake.sample_baked_sigma(torch.as_tensor(grid),
                                    torch.as_tensor(pos.reshape(4, -1, 3)))
    np.testing.assert_array_equal(got3.numpy().reshape(-1), got)


def test_feature_sampler_matches_jax():
    rng = np.random.default_rng(7)
    feat = torch.as_tensor(rng.uniform(-2, 2, (16 ** 3, 16)).astype(
        np.float32)).bfloat16()
    pos = _points()
    got = tbake.sample_feat_grid(feat, torch.as_tensor(pos))
    want = jbake.sample_feat_grid(
        jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(pos))
    assert got.dtype == torch.float32 and got.shape == (4096, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 1e-3)])
def test_rgb_from_features_matches_jax(testbeds, dtype, atol):
    j, t = testbeds["trained"]
    rng = np.random.default_rng(8)
    feat = rng.normal(0, 2, (2048, 16)).astype(np.float32)
    dir01 = rng.uniform(0, 1, (2048, 3)).astype(np.float32)
    got = t.net.rgb_from_features(torch.as_tensor(feat),
                                  torch.as_tensor(dir01),
                                  compute_dtype=getattr(torch, dtype))
    want = rgb_from_features(j.params, jnp.asarray(feat), jnp.asarray(dir01),
                             j.config, compute_dtype=getattr(jnp, dtype))
    assert got.shape == (2048, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)

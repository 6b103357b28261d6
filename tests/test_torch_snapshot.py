"""Snapshot load parity: the PyTorch port against the JAX package.

Both packages load the same snapshot file; every param array, the density
grid, the occupancy and the jump grid must be exactly equal (tolerance
0: both decode the same fp16 blob and threshold the same values).
"""

import os

import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.io import snapshot as jsnap
from nerf_glasses_tpu.ops import network as jnet
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.io import snapshot as tsnap
from nerf_glasses_tpu_torch.models.testbed import Testbed
from nerf_glasses_tpu_torch.ops import network as tnet
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from tests.helpers import TEST_CFG, write_test_snapshot

torch.set_num_threads(1)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "trained", "trained_head_v6.msgpack")


@pytest.fixture(scope="module", params=["trained_head_v6", "test_cfg"])
def snapshot(request, tmp_path_factory):
    if request.param == "trained_head_v6":
        return TRAINED
    path = tmp_path_factory.mktemp("snap") / "test_cfg.msgpack"
    write_test_snapshot(path, cfg=TEST_CFG, seed=3)
    return str(path)


def _jax_params(path):
    s = jsnap.load_snapshot(path)
    p = jnet.unpack_params(s.params_blob, s.config)
    return s, {"density_mlp": tuple(np.asarray(w) for w in p["density_mlp"]),
               "rgb_mlp": tuple(np.asarray(w) for w in p["rgb_mlp"]),
               "grid": np.asarray(p["grid"])}


def test_config_and_metadata_equal(snapshot):
    js = jsnap.load_snapshot(snapshot)
    ts = tsnap.load_snapshot(snapshot)
    jc, tc = js.config, ts.config
    for f in ("n_levels", "n_features_per_level", "log2_hashmap_size",
              "base_resolution", "per_level_scale", "sh_degree",
              "density_neurons", "density_hidden_layers", "rgb_neurons",
              "rgb_hidden_layers", "aabb_scale", "all_hash",
              "density_activation", "rgb_activation"):
        assert getattr(jc, f) == getattr(tc, f), f
    assert jc.level_params() == tc.level_params()
    assert jc.mlp_shapes() == tc.mlp_shapes()
    assert jc.n_params == tc.n_params
    np.testing.assert_array_equal(js.params_blob, ts.params_blob)
    for a in ("aabb", "render_aabb"):
        np.testing.assert_array_equal(getattr(js, a).min, getattr(ts, a).min)
        np.testing.assert_array_equal(getattr(js, a).max, getattr(ts, a).max)
    np.testing.assert_array_equal(js.render_aabb_to_local,
                                  ts.render_aabb_to_local)
    np.testing.assert_array_equal(js.dataset.xforms, ts.dataset.xforms)
    np.testing.assert_array_equal(js.dataset.up, ts.dataset.up)


def test_params_exact(snapshot):
    js, jp = _jax_params(snapshot)
    ts = tsnap.load_snapshot(snapshot)
    net = tnet.unpack_params(ts.params_blob, ts.config)
    F = ts.config.n_features_per_level
    np.testing.assert_array_equal(net.grid.numpy(), jp["grid"][..., :F])
    for tw, jw in zip(net.density_mlp + net.rgb_mlp,
                      jp["density_mlp"] + jp["rgb_mlp"]):
        np.testing.assert_array_equal(tw.numpy(), jw)


def test_params_from_jax_matches_own_loader(snapshot):
    _, jp = _jax_params(snapshot)
    ts = tsnap.load_snapshot(snapshot)
    own = tnet.unpack_params(ts.params_blob, ts.config).state_dict()
    via = tnet.params_from_jax(jp, ts.config).state_dict()
    assert own.keys() == via.keys()
    for k in own:
        assert torch.equal(own[k], via[k]), k


def test_density_grid_occupancy_and_skip_grid_exact(snapshot):
    js = jsnap.load_snapshot(snapshot)
    ts = tsnap.load_snapshot(snapshot)
    np.testing.assert_array_equal(js.density_grid, ts.density_grid)
    mc = ts.config.max_cascade
    jo = np.asarray(jocc.build_occupancy(js.density_grid, mc))
    to = tocc.build_occupancy(torch.as_tensor(ts.density_grid), mc)
    np.testing.assert_array_equal(jo, to.numpy())
    np.testing.assert_array_equal(np.asarray(jocc.build_skip_grid(jo)),
                                  tocc.build_skip_grid(to).numpy())


def test_testbed_load(snapshot):
    tb = Testbed(device="cpu")
    tb.load_snapshot(snapshot)
    js = jsnap.load_snapshot(snapshot)
    jo = np.asarray(jocc.build_occupancy(js.density_grid,
                                         js.config.max_cascade))
    np.testing.assert_array_equal(tb.occ.numpy(), jo)
    assert tb.net.grid.device.type == "cpu"


@pytest.mark.parametrize("cfg", [
    dict(), dict(log2_hashmap_size=15), dict(aabb_scale=4),
    dict(n_levels=4, log2_hashmap_size=7, base_resolution=4,
         per_level_scale=2.0)], ids=["default", "T15", "aabb4", "small"])
def test_level_params_match(cfg):
    assert JCfg(**cfg).level_params() == TCfg(**cfg).level_params()
    assert JCfg(**cfg).mlp_shapes() == TCfg(**cfg).mlp_shapes()
    assert JCfg.native_fast().level_params() == TCfg.native_fast().level_params()


def test_unsupported_otype_rejected():
    doc = JCfg().to_snapshot_config()
    doc["network"]["otype"] = "CutlassResNet"
    with pytest.raises(ValueError):
        TCfg.from_snapshot_config(doc, 1)

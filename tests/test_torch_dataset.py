"""Dataset, snapshot-save and parameter-init parity: the PyTorch port
against the JAX package.

Tolerances: the loaders, conversions, json sections and packed fp16
blobs are the same numpy arithmetic and must be equal (images to atol
1e-6); snapshots saved by one package and loaded by the other must give
every param, grid cell, config field and dataset field exactly; the
sRGB supervision images are f32 pow and held to atol 1e-6.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.io import dataset as jds
from nerf_glasses_tpu.io import snapshot as jsnap
from nerf_glasses_tpu.models.testbed import Testbed as JTestbed
from nerf_glasses_tpu.ops import hashgrid as jhash
from nerf_glasses_tpu.ops import network as jnet
from nerf_glasses_tpu.ops import occupancy as jocc
from nerf_glasses_tpu.train import trainer as jtr
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.io import dataset as tds
from nerf_glasses_tpu_torch.io import snapshot as tsnap
from nerf_glasses_tpu_torch.models.testbed import Testbed as TTestbed
from nerf_glasses_tpu_torch.ops import hashgrid as thash
from nerf_glasses_tpu_torch.ops import network as tnet
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.train import trainer as ttr
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox as TBox
from tests.helpers import TEST_CFG, write_test_snapshot
from tests.test_apps import write_disk_dataset
from tests.test_training import make_synth_dataset

torch.set_num_threads(1)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "trained", "trained_head_v6.msgpack")
CONFIG_FIELDS = [f for f in TCfg.__dataclass_fields__]
SCALAR_DS_FIELDS = ("n_images", "envmap_resolution", "scale", "aabb_scale",
                    "from_mitsuba", "is_hdr", "wants_importance_sampling")


def port_dataset(jd) -> tds.NerfDataset:
    """The JAX package's NerfDataset as the port's (same field values)."""
    d = tds.NerfDataset()
    for f in dataclasses.fields(tds.NerfDataset):
        v = getattr(jd, f.name)
        if f.name == "metadata":
            v = [tds.ImageMetadata(**dataclasses.asdict(m)) for m in v]
        elif f.name == "render_aabb":
            v = TBox(v.min, v.max)
        setattr(d, f.name, v)
    return d


def _tcfg(jc):
    return TCfg(**{f: getattr(jc, f) for f in CONFIG_FIELDS})


def _assert_dataset_equal(a, b):
    np.testing.assert_array_equal(a.xforms, b.xforms)
    np.testing.assert_array_equal(a.xforms_end, b.xforms_end)
    assert a.paths == b.paths
    for f in SCALAR_DS_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ("up", "offset", "render_aabb_to_local"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.render_aabb.min, b.render_aabb.min)
    np.testing.assert_array_equal(a.render_aabb.max, b.render_aabb.max)
    for ma, mb in zip(a.metadata, b.metadata):
        assert dataclasses.asdict(ma) == dataclasses.asdict(mb)


# ---------------------------------------------------------------------------
# transforms.json and conversions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    d = write_disk_dataset(tmp_path_factory.mktemp("disk"))
    # per-frame overrides and lens parameters the loader must carry
    with open(d / "transforms.json") as f:
        doc = json.load(f)
    doc["frames"][1].update({"k1": 0.01, "k2": -0.002, "p1": 0.0005,
                             "p2": -0.0003})
    del doc["fl_x"], doc["fl_y"]
    doc["camera_angle_x"] = 2.0 * math.atan(0.5 / 0.9)
    doc["sharpen"] = 0.5
    with open(d / "transforms_lens.json", "w") as f:
        json.dump(doc, f)
    return d


@pytest.mark.parametrize("name", ["transforms.json", "transforms_lens.json"])
def test_load_transforms_json(disk_dataset, name):
    path = str(disk_dataset / name)
    jd = jds.load_transforms_json(path)
    td = tds.load_transforms_json(path)
    _assert_dataset_equal(td, jd)
    assert len(td.images) == jd.n_images == 6
    for a, b in zip(td.images, jd.images):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert td.depth_images is None and jd.depth_images is None


def test_load_transforms_json_depth(tmp_path):
    from PIL import Image
    d = write_disk_dataset(tmp_path, n_images=2)
    depth = (np.arange(64 * 64, dtype=np.uint16).reshape(64, 64) * 7)
    Image.fromarray(depth).save(tmp_path / "d0.png")
    with open(d / "transforms.json") as f:
        doc = json.load(f)
    doc["integer_depth_scale"] = 1e-3
    doc["frames"][0]["depth_path"] = "d0.png"
    with open(d / "transforms.json", "w") as f:
        json.dump(doc, f)
    jd = jds.load_transforms_json(str(d))
    td = tds.load_transforms_json(str(d))
    assert td.depth_images[1] is None and jd.depth_images[1] is None
    np.testing.assert_array_equal(td.depth_images[0], jd.depth_images[0])
    assert td.depth_images[0].max() > 0


def test_conversions_round_trip():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(3, 4)).astype(np.float32)
    p = rng.normal(size=3).astype(np.float32)
    off = np.array([0.5, 0.4, 0.6], np.float32)
    for mit in (False, True):
        for sc in (False, True):
            a = tds.nerf_matrix_to_ngp(m, 0.33, off, mit, sc)
            np.testing.assert_array_equal(
                a, jds.nerf_matrix_to_ngp(m, 0.33, off, mit, sc))
            back = tds.ngp_matrix_to_nerf(a, 0.33, off, mit, sc)
            np.testing.assert_array_equal(
                back, jds.ngp_matrix_to_nerf(a, 0.33, off, mit, sc))
            np.testing.assert_allclose(back, m, atol=1e-5)
        q = tds.nerf_position_to_ngp(p, 0.33, off, mit)
        np.testing.assert_array_equal(q, jds.nerf_position_to_ngp(p, 0.33,
                                                                   off, mit))
        np.testing.assert_allclose(tds.ngp_position_to_nerf(q, 0.33, off, mit),
                                   p, atol=1e-5)
        np.testing.assert_array_equal(tds.nerf_direction_to_ngp(p, mit),
                                      jds.nerf_direction_to_ngp(p, mit))
    for a, b in zip(tds.nerf_ray_to_ngp(p, p, 0.33, off, True),
                    jds.nerf_ray_to_ngp(p, p, 0.33, off, True)):
        np.testing.assert_array_equal(a, b)


def test_dataset_json_and_empty_dataset(disk_dataset):
    path = str(disk_dataset / "transforms_lens.json")
    jd = jds.load_transforms_json(path, load_images=False)
    td = tds.load_transforms_json(path, load_images=False)
    assert tds.dataset_to_json(td) == jds.dataset_to_json(jd)
    back = tds.dataset_from_json(tds.dataset_to_json(td))
    assert tds.dataset_to_json(back) == jds.dataset_to_json(jd)
    te = tds.create_empty_nerf_dataset(3, 2, True)
    je = jds.create_empty_nerf_dataset(3, 2, True)
    assert tds.dataset_to_json(te) == jds.dataset_to_json(je)
    assert te.images == [None] * 3


def test_sharpen_and_image_load(disk_dataset):
    img = tds.load_training_image(str(disk_dataset / "im_0.png"))
    np.testing.assert_array_equal(
        img, jds.load_training_image(str(disk_dataset / "im_0.png")))
    for amount in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(tds.sharpen_image(img, amount),
                                   jds.sharpen_image(img, amount),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("hdr", [False, True])
def test_prepare_dataset_arrays(hdr):
    """The LDR -> sRGB supervision images and the camera arrays."""
    jd = make_synth_dataset(n_images=3)
    jd.is_hdr = hdr
    jd.metadata[2].lens_mode = "opencv"
    jd.metadata[2].lens_params = (0.01, -0.02, 0.003, 0.0, 0.0, 0.0, 0.0)
    jd.depth_images = [None, np.full((64, 64), 0.7, np.float32), None]
    j = jtr.prepare_dataset_arrays(jd)
    t = ttr.prepare_dataset_arrays(port_dataset(jd))
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert ttr.dataset_has_distortion(port_dataset(jd))


# ---------------------------------------------------------------------------
# Init and pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [TEST_CFG, JCfg.native_fast(),
                                 JCfg(n_levels=4, log2_hashmap_size=11,
                                      base_resolution=16,
                                      per_level_scale=1.7)],
                         ids=["test_cfg", "native_fast", "small"])
def test_init_pack_and_table_to_tcnn(cfg):
    """init_params: shapes, U(-1e-4, 1e-4) table, Xavier bounds per
    matrix; pack_params and table_to_tcnn equal to the JAX package's on
    the same values; rows past a level's size are never packed."""
    tc = _tcfg(cfg)
    net = tnet.init_params(tc, torch.Generator().manual_seed(0))
    jp = jnet.init_params(jax.random.PRNGKey(0), cfg)
    assert tuple(net.grid.shape) == tuple(jp["grid"].shape)
    for tw, jw in zip(net.density_mlp + net.rgb_mlp,
                      jp["density_mlp"] + jp["rgb_mlp"]):
        assert tuple(tw.shape) == tuple(jw.shape)
        n_out, n_in = tw.shape
        bound = math.sqrt(6.0 / (n_in + n_out))
        assert float(tw.abs().max()) <= bound
        assert float(tw.abs().max()) > 0.9 * bound
        assert abs(float(tw.mean())) < 0.1 * bound
    g = net.grid.numpy()
    assert np.abs(g).max() <= 1e-4 and np.abs(g).max() > 0.99e-4
    assert not any(p.requires_grad for p in net.parameters())

    jparams = {"density_mlp": tuple(jnp.asarray(w.numpy())
                                    for w in net.density_mlp),
               "rgb_mlp": tuple(jnp.asarray(w.numpy()) for w in net.rgb_mlp),
               "grid": jnp.asarray(g)}
    blob = tnet.pack_params(net)
    assert blob.dtype == np.float16 and blob.size == cfg.n_params
    np.testing.assert_array_equal(blob, jnet.pack_params(jparams, cfg))
    np.testing.assert_array_equal(thash.table_to_tcnn(g, tc),
                                  jhash.table_to_tcnn(g, cfg))
    # poison the rows past each level's hashmap size: the blob is unchanged
    for lvl, (_off, size, _res) in enumerate(tc.level_params()):
        net.grid.data[lvl, size:] = float("nan")
    np.testing.assert_array_equal(tnet.pack_params(net), blob)
    round_trip = tnet.unpack_params(blob, tc)
    np.testing.assert_array_equal(tnet.pack_params(round_trip), blob)


def test_config_and_morton_save_layout():
    for cfg in (TEST_CFG, JCfg.native_fast(), JCfg(aabb_scale=4)):
        assert _tcfg(cfg).to_snapshot_config() == cfg.to_snapshot_config()
    grid = np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 128)
                                            ).astype(np.float32)
    m = tocc.linear_cascades_to_morton(grid)
    np.testing.assert_array_equal(m, jocc.linear_cascades_to_morton(grid))
    np.testing.assert_array_equal(tocc.morton_cascades_to_linear(m), grid)


# ---------------------------------------------------------------------------
# Snapshot save, both directions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["trained_head_v6", "fresh_test_cfg"])
def snapshot(request, tmp_path_factory):
    if request.param == "trained_head_v6":
        return TRAINED
    path = tmp_path_factory.mktemp("snap") / "fresh.msgpack"
    write_test_snapshot(path, cfg=TEST_CFG, seed=5)
    return str(path)


def _assert_snapshots_equal(a, b):
    for f in CONFIG_FIELDS:
        assert getattr(a.config, f) == getattr(b.config, f), f
    np.testing.assert_array_equal(a.params_blob, b.params_blob)
    np.testing.assert_array_equal(a.density_grid, b.density_grid)
    for box in ("aabb", "render_aabb"):
        np.testing.assert_array_equal(getattr(a, box).min, getattr(b, box).min)
        np.testing.assert_array_equal(getattr(a, box).max, getattr(b, box).max)
    np.testing.assert_array_equal(a.render_aabb_to_local,
                                  b.render_aabb_to_local)
    assert a.training_step == b.training_step
    assert a.loss == b.loss
    assert a.bounding_radius == b.bounding_radius
    _assert_dataset_equal(a.dataset, b.dataset)


def test_port_save_jax_load(snapshot, tmp_path):
    tb = TTestbed(device="cpu")
    tb.load_snapshot(snapshot)
    tb.training_step, tb.loss = 1234, 0.0025
    out = str(tmp_path / "port.msgpack")
    tb.save_snapshot(out)
    want = jsnap.load_snapshot(snapshot)
    want.training_step, want.loss = 1234, float(np.float64(0.0025))
    _assert_snapshots_equal(jsnap.load_snapshot(out), want)
    _assert_snapshots_equal(tsnap.load_snapshot(out), want)


def test_jax_save_port_load(snapshot, tmp_path):
    jt = JTestbed()
    jt.load_snapshot(snapshot)
    jt.training_step, jt.loss = 77, 0.5
    out = str(tmp_path / "jax.msgpack")
    jt.save_snapshot(out)
    got = tsnap.load_snapshot(out)
    _assert_snapshots_equal(got, jsnap.load_snapshot(out))
    net = tnet.unpack_params(got.params_blob, got.config)
    np.testing.assert_array_equal(
        net.grid.numpy(),
        np.asarray(jt.params["grid"])[..., :got.config.n_features_per_level])


def test_save_clamps_grid_to_fp16(tmp_path):
    cfg = _tcfg(TEST_CFG)
    net = tnet.init_params(cfg, torch.Generator().manual_seed(1))
    grid = np.zeros((1, 128, 128, 128), np.float32)
    grid[0, 1, 2, 3] = 1e6
    grid[0, 4, 5, 6] = -1e6
    ds = tds.create_empty_nerf_dataset(1)
    box = TBox([0, 0, 0], [1, 1, 1])
    out = str(tmp_path / "c.msgpack")
    tsnap.save_snapshot(out, cfg, tnet.pack_params(net), grid, ds, box, box,
                        np.eye(3, dtype=np.float32))
    s = jsnap.load_snapshot(out)
    assert s.density_grid[0, 1, 2, 3] == 65504.0
    assert s.density_grid[0, 4, 5, 6] == -65504.0
    assert np.isfinite(s.density_grid).all()

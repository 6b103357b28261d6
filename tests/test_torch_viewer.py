"""The port's browser viewer over HTTP: the cases of tests/test_viewer.py
against nerf_glasses_tpu_torch.apps.viewer_app, every endpoint of its
panel, and frames from handler threads on a Testbed that trains (no
autograd graph: grad mode is per thread)."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pynmr_torch
from nerf_glasses_tpu.apps import viewer_app as jviewer
from nerf_glasses_tpu_torch.apps import viewer_app
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.train.trainer import TrainOptions, Trainer
from tests.helpers import write_quad_gltf, write_test_snapshot
from tests.test_apps import write_disk_dataset

torch.set_num_threads(1)

W, H = 32, 24
OVERRIDES = {"max_rounds": 16, "jitter": False, "compute_dtype": "float32"}


def _serve(renderer):
    server = viewer_app.make_server(renderer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viewer")
    snap = tmp / "s.msgpack"
    write_test_snapshot(snap)
    renderer = pynmr_torch.NerfMeshRenderer(W, H, device="cpu")
    renderer.load_nerf(str(snap)).march_overrides = dict(OVERRIDES)
    server, base = _serve(renderer)
    yield base, renderer, tmp
    server.shutdown()
    server.server_close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


def _post(base, name, body):
    req = urllib.request.Request(
        base + "/api/" + name, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _decode(jpeg):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(jpeg)))


def test_page_is_the_jax_page_but_for_its_title():
    title = "<title>nerf-glasses-tpu viewer</title>"
    assert title in jviewer._PAGE
    assert viewer_app._PAGE == jviewer._PAGE.replace(
        title, "<title>nerf-glasses-tpu viewer (PyTorch port)</title>")


def test_page_and_frame(viewer):
    base, _, _ = viewer
    status, body = _get(base, "/")
    assert status == 200 and b"nerf-glasses-tpu viewer" in body
    status, body = _get(base, "/frame.jpg")
    assert status == 200 and body[:2] == b"\xff\xd8"  # JPEG magic
    assert _decode(body).shape == (H, W, 3)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nothing")
    assert e.value.code == 404


def test_orbit_changes_frame(viewer):
    base, renderer, _ = viewer
    _, before = _get(base, "/frame.jpg")
    cam = renderer.view_projection_mat.copy()
    assert _post(base, "orbit", {"da": 0.8, "dp": 0.2, "dz": 0.0}) == \
        (200, {"ok": True})
    assert not np.allclose(cam, renderer.view_projection_mat)
    _, after = _get(base, "/frame.jpg")
    assert before != after


def test_stats_panel(viewer):
    base, renderer, _ = viewer
    _get(base, "/frame.jpg")
    status, body = _get(base, "/api/stats")
    s = json.loads(body)
    assert status == 200
    assert set(s) == set(renderer.stats())
    assert {"fps", "frame_ms", "n_nerfs", "frame_count",
            "hbm_bytes_in_use"} <= set(s)
    assert s["n_nerfs"] == 1 and s["frame_count"] >= 1
    assert s["render_path"] == "unbaked" and s["hbm_available"] is False


def test_mesh_panel_actions(viewer):
    base, renderer, tmp = viewer
    quad = write_quad_gltf(tmp / "q.gltf")
    status, _ = _post(base, "load_mesh",
                      {"path": str(quad), "t": [0, 0, 0.2], "s": [0.3] * 3})
    assert status == 200 and len(renderer._meshes) == 1
    arrays = renderer._mesh_arrays
    _post(base, "transform", {"mesh": 0, "t": [0.1, 0, 0.2], "yaw_deg": 45,
                              "s": 0.25})
    node = renderer._meshes[0].nodes[0]
    assert np.allclose(node.translation, [0.1, 0, 0.2])
    assert np.allclose(node.scale, 0.25)
    assert abs(node.rotation[0] - np.cos(np.deg2rad(22.5))) < 1e-6
    assert renderer._mesh_arrays is not arrays          # rebuilt
    _post(base, "transform", {"r": [1, 0, 0, 0]})
    assert np.allclose(node.rotation, [1, 0, 0, 0])
    _, with_mesh = _get(base, "/frame.jpg")
    assert int((renderer._nerfs[0]._surface_t > 0).sum()) > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "load_mesh", {"path": str(tmp / "missing.gltf")})
    assert e.value.code == 500
    _post(base, "clear", {"what": "meshes"})
    assert len(renderer._meshes) == 0
    _, without = _get(base, "/frame.jpg")
    assert with_mesh != without


def test_density_light_and_errors(viewer):
    base, renderer, tmp = viewer
    f = tmp / "grid.bin"
    _post(base, "density", {"op": "dump", "filename": str(f)})
    assert f.exists() and f.stat().st_size == 8 * 128 ** 3
    before = renderer._nerfs[0].occ.clone()
    _post(base, "density", {"op": "load", "filename": str(f)})
    assert torch.equal(renderer._nerfs[0].occ, before)
    _post(base, "light", {"pos": [0.0, 2.0, 1.0]})
    assert np.allclose(renderer.light_pos, [0, 2, 1])
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "nonsense", {})
    assert e.value.code == 500
    assert b"nonsense" in e.value.read()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "toggle", {"name": "nonsense"})
    assert e.value.code == 500


def test_collide_floaties_and_trajectory_endpoints(viewer):
    base, renderer, tmp = viewer
    quad = write_quad_gltf(tmp / "drop.gltf")
    _post(base, "load_mesh", {"path": str(quad), "t": [0.0, 0.35, 0.0],
                              "s": [0.1] * 3,
                              "r": [0.7071068, 0.7071068, 0, 0]})
    node = renderer._meshes[0].nodes[0]
    assert _post(base, "collide", {"direction": [0, -1, 0], "mesh": 0}) == \
        (200, {"ok": True})
    assert 0.0 < node.translation[1] < 0.30             # it fell on the sphere
    assert _post(base, "remove_floaties", {})[0] == 200
    assert int(renderer._nerfs[0].occ[0, 64, 64, 64]) == 1
    out = tmp / "traj"
    out.mkdir()
    cam = renderer.view_projection_mat.copy()
    _post(base, "record_trajectory", {"num_images": 3.0,
                                      "out_dir": str(out)})
    names = sorted(p.name for p in out.iterdir())
    # the recorder's float angle steps may add a frame, as in the JAX
    # package (tests/test_apps.py:131)
    assert {"trajectory_1.jpg", "trajectory_2.jpg", "trajectory_3.jpg",
            "transform_1", "transform_2", "transform_3"} <= set(names)
    assert not np.allclose(cam, renderer.view_projection_mat)
    _post(base, "clear", {"what": "meshes"})


def test_toggles_and_bake(viewer):
    base, renderer, _ = viewer
    nerf = renderer._nerfs[0]
    _, plain = _get(base, "/frame.jpg")
    _post(base, "toggle", {"name": "visualize_depth", "value": True})
    assert renderer.visualize_depth
    _, overlay = _get(base, "/frame.jpg")
    assert overlay != plain
    _post(base, "toggle", {"name": "visualize_depth", "value": False})
    _post(base, "toggle", {"name": "profile", "value": True})
    assert renderer.profile
    _get(base, "/frame.jpg")
    assert json.loads(_get(base, "/api/stats")[1])["nerf_ms"] > 0
    _post(base, "toggle", {"name": "profile", "value": False})
    # flash bakes on first use
    _post(base, "toggle", {"name": "flash", "value": True, "resolution": 32})
    assert nerf.flash and tuple(nerf._baked_sigma.shape) == (32, 32, 32)
    _get(base, "/frame.jpg")
    assert json.loads(_get(base, "/api/stats")[1])["render_path"] == "flash"
    _post(base, "toggle", {"name": "flash", "value": False})
    _post(base, "bake", {"resolution": 16})
    assert tuple(nerf._baked_sigma.shape) == (16, 16, 16)
    _get(base, "/frame.jpg")
    assert json.loads(_get(base, "/api/stats")[1])["render_path"] == "baked"
    nerf.unbake()
    _post(base, "clear", {"what": "nerfs"})
    assert renderer.stats()["n_nerfs"] == 0
    assert _decode(_get(base, "/frame.jpg")[1]).shape == (H, W, 3)
    _post(base, "load_nerf", {"path": str(viewer[2] / "s.msgpack")})
    renderer._nerfs[0].march_overrides = dict(OVERRIDES)
    assert renderer.stats()["n_nerfs"] == 1


def test_handler_threads_build_no_graph(tmp_path):
    """A Testbed that trains renders its trainer's live network, whose
    parameters require grad. Frames, collide and floaty removal asked for
    over HTTP run in handler threads, where grad mode starts enabled:
    nothing they make may carry a graph."""
    d = write_disk_dataset(tmp_path, n_images=2)
    tb = pynmr_torch.Testbed(device="cpu")
    tb.config = NGPConfig(n_levels=4, log2_hashmap_size=11,
                          base_resolution=16, per_level_scale=1.7)
    tb.load_training_data(str(d))
    tb._trainer = Trainer(tb.dataset, TrainOptions(
        config=tb.config, rays_per_batch=256, samples_per_ray=16,
        grid_samples_per_update=1 << 12, compute_dtype="float32"),
        device="cpu")
    tb.train(2)
    tb.set_fov(45.0)
    tb.march_overrides = dict(OVERRIDES)
    assert tb.net.grid.requires_grad
    renderer = pynmr_torch.NerfMeshRenderer(W, H, device="cpu")
    tb.camera_matrix = renderer.view_projection_mat.copy()
    renderer._nerfs.append(tb)

    seen = []
    real = tb.net.density_raw

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_grad_enabled(), out.requires_grad))
        return out

    tb.net.density_raw = spy
    server, base = _serve(renderer)
    try:
        quad = write_quad_gltf(tmp_path / "q.gltf")
        _post(base, "load_mesh", {"path": str(quad), "t": [0.0, 0.3, 0.0],
                                  "s": [0.2] * 3,
                                  "r": [0.7071068, 0.7071068, 0, 0]})
        assert _decode(_get(base, "/frame.jpg")[1]).shape == (H, W, 3)
        _post(base, "toggle", {"name": "visualize_depth", "value": True})
        _get(base, "/frame.jpg")
        _post(base, "collide", {"direction": [0, -1, 0], "mesh": 0})
        _post(base, "remove_floaties", {})
        _post(base, "toggle", {"name": "flash", "value": True,
                               "resolution": 16})
        _get(base, "/frame.jpg")
    finally:
        server.shutdown()
        server.server_close()
        del tb.net.density_raw
    assert seen and not any(main for main, _, _ in seen)
    assert not any(enabled or req for _, enabled, req in seen)
    for t in (renderer._frame_buffer, renderer._depth_buffer, renderer._accum,
              tb._surface_rgba, tb._surface_t, tb.occ, tb._baked_sigma,
              tb._baked_feat):
        assert t.grad_fn is None and not t.requires_grad
    assert torch.is_grad_enabled()
    tb.train(1)                                 # and training goes on
    assert np.isfinite(tb.loss)

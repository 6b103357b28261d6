"""pynmr_torch and the port's render app against pynmr and the JAX app.

The landmark flow follows tests/test_placement.py:126-157: ground-truth 3D
landmarks projected through the live camera stand in for MediaPipe, and
the reference landmarks are seeded. Tolerances: the triangulated landmarks
recover the ground truth to 5e-3 and equal the JAX app's to 1e-4; the
whole app (run) places the glasses like the JAX app to 1e-4 and its last
frame is >= 50 dB from the JAX app's.
"""

import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pynmr
import pynmr_torch
from nerf_glasses_tpu.apps import render_app as japp
from nerf_glasses_tpu_torch.apps import render_app as tapp
from nerf_glasses_tpu_torch.utils import placement
from tests.helpers import write_quad_gltf, write_test_snapshot
from tests.test_placement import project_to_landmark

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 32, 24
OVERRIDES = {"max_rounds": 4, "jitter": False, "compute_dtype": "float32"}
G_LEFT = np.array([-0.5, 0.5, 0.0])
G_RIGHT = np.array([0.5, 0.5, 0.0])


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else 10.0 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def snapshot_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("snap") / "s.msgpack"
    write_test_snapshot(p)
    return str(p)


def _ground_truth():
    """A plausible face in renderer world space: nose, temples, eyes."""
    nose = np.array([0.0, 0.05, 0.08])
    pts = [nose, nose + [0, -0.01, 0.01], nose + [0, -0.02, 0.02],
           [-0.08, 0.07, 0.0], [0.08, 0.07, 0.0],
           [-0.085, 0.05, 0.0], [0.085, 0.05, 0.0],
           [-0.04, 0.06, 0.06], [0.04, 0.06, 0.06]]
    gt = {i: np.zeros(3) for i in range(478)}
    for lm_id, p in zip(placement.LANDMARK_ORDER, pts):
        gt[lm_id] = np.asarray(p, np.float64)
    return gt


GT = _ground_truth()
REFERENCE = np.random.default_rng(0).standard_normal((478, 3))


def landmark_fn(renderer, nerf):
    cam = renderer.view_projection_mat
    lms = np.zeros((478, 3), np.float32)
    for lm_id, p in GT.items():
        x, y = project_to_landmark(cam, p)
        lms[lm_id] = [x, y, 0.0]
    return lms


# ---------------------------------------------------------------------------
# pynmr_torch
# ---------------------------------------------------------------------------

def test_every_public_name_of_pynmr_exists():
    names = [n for n in vars(pynmr) if not n.startswith("_")
             and n not in ("enum", "np")]
    assert {"NerfMeshRenderer", "Testbed", "BoundingBox", "GltfNode",
            "GltfScene", "GltfMesh", "NerfDataset", "free_temporary_memory",
            "LossType", "NerfActivation", "ColorSpace", "TonemapCurve",
            "LensMode", "GroundTruthRenderMode", "Vec3"} <= set(names)
    for n in names:
        assert hasattr(pynmr_torch, n), n
        a, b = getattr(pynmr, n), getattr(pynmr_torch, n)
        if isinstance(a, type) and issubclass(a, enum.Enum):
            assert {k: v.value for k, v in a.__members__.items()} == \
                {k: v.value for k, v in b.__members__.items()}
    assert pynmr_torch.LossType.SmoothL1 is pynmr_torch.LossType.Huber
    np.testing.assert_array_equal(pynmr_torch.Vec3(1, 2, 3),
                                  pynmr.Vec3(1, 2, 3))
    assert pynmr_torch.Vec3().dtype == np.float32
    assert pynmr_torch.free_temporary_memory() is None


def test_pynmr_torch_objects_are_the_ports():
    r = pynmr_torch.NerfMeshRenderer(8, 6, device="cpu")
    assert type(r).__module__ == "nerf_glasses_tpu_torch.models.renderer"
    assert r.view_projection_mat.shape == (3, 4)
    assert r.loadNerf == r.load_nerf and r.removeFloaties == r.remove_floaties
    assert pynmr_torch.NerfMeshRenderer(8, 6).device.type == "cuda"
    assert pynmr_torch.Testbed().device.type == "cuda"
    for cls in (pynmr_torch.Testbed, pynmr_torch.BoundingBox,
                pynmr_torch.GltfNode, pynmr_torch.GltfScene,
                pynmr_torch.GltfMesh, pynmr_torch.NerfDataset):
        assert cls.__module__.startswith("nerf_glasses_tpu_torch.")


def test_apps_import_without_jax():
    """pynmr_torch and both apps import with jax unimportable and pull in
    nothing of the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import pynmr_torch, nerf_glasses_tpu_torch.apps.render_app, "
            "nerf_glasses_tpu_torch.apps.viewer_app, "
            "nerf_glasses_tpu_torch.models.floaty, "
            "nerf_glasses_tpu_torch.utils.placement; "
            "bad = [m for m in sys.modules if m == 'nerf_glasses_tpu' or "
            "m.startswith('nerf_glasses_tpu.') or m == 'pynmr' or "
            "m.startswith('jax.') or m == 'jaxlib']; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# render_app
# ---------------------------------------------------------------------------

def _app_renderers(snapshot_path):
    jr = pynmr.NerfMeshRenderer(W, H)
    tr = pynmr_torch.NerfMeshRenderer(W, H, device="cpu")
    nerfs = []
    for r in (jr, tr):
        nerfs.append(r.load_nerf(snapshot_path))
        nerfs[-1].march_overrides = dict(OVERRIDES)
    return (jr, nerfs[0]), (tr, nerfs[1])


def test_find_3d_landmarks_recovers_and_matches_jax(snapshot_path):
    (jr, jn), (tr, tn) = _app_renderers(snapshot_path)
    out_j = japp.find_3d_landmarks(jr, jn, landmark_fn, REFERENCE)
    out_t = tapp.find_3d_landmarks(tr, tn, landmark_fn, REFERENCE)
    assert len(out_t) == len(placement.LANDMARK_ORDER)
    for k, lm_id in enumerate(placement.LANDMARK_ORDER):
        np.testing.assert_allclose(out_t[k], GT[lm_id], atol=5e-3)
        np.testing.assert_allclose(out_t[k], out_j[k], atol=1e-4)
    np.testing.assert_array_equal(tr.view_projection_mat,
                                  jr.view_projection_mat)
    assert tr.stats()["frame_count"] == jr.stats()["frame_count"] > 60


def test_rotate_camera_searches_until_a_face_shows(snapshot_path):
    """The provider sees no face on the first three views: the app orbits
    on, then turns to the face; the same camera as the JAX app's."""
    cams = []
    for app, (r, n) in zip((japp, tapp), _app_renderers(snapshot_path)):
        calls = []

        def shy(renderer, nerf):
            calls.append(1)
            return None if len(calls) <= 3 else landmark_fn(renderer, nerf)

        assert app.rotate_camera_to_face_face(r, n, shy, REFERENCE)
        assert len(calls) == 4
        cams.append(r.view_projection_mat)
    np.testing.assert_array_equal(cams[1], cams[0])
    r, n = _app_renderers(snapshot_path)[1]
    assert not tapp.rotate_camera_to_face_face(r, n, lambda *a: None,
                                               REFERENCE, max_tries=2)


def _with_overrides(cls, **kw):
    """The renderer class with the tests' march options on every NeRF it
    loads (run() builds its renderer itself)."""
    class Small(cls):
        def __init__(self, width, height, **ckw):
            super().__init__(width, height, **{**ckw, **kw})

        def load_nerf(self, path, **lkw):
            nerf = super().load_nerf(path, **lkw)
            nerf.march_overrides = dict(OVERRIDES)
            return nerf
    return Small


def test_run_places_the_glasses_like_the_jax_app(snapshot_path, tmp_path,
                                                 monkeypatch, capsys):
    """The whole app in both packages at 32x24: sweep, triangulation,
    placement, three orbit frames."""
    quad = str(write_quad_gltf(tmp_path / "glasses.gltf"))
    monkeypatch.chdir(tmp_path)         # no envmap file here: passed over
    for app in (japp, tapp):
        monkeypatch.setattr(app, "W", W)
        monkeypatch.setattr(app, "H", H)
    monkeypatch.setattr(tapp, "DEVICE", "cpu")
    monkeypatch.setattr(pynmr, "NerfMeshRenderer",
                        _with_overrides(pynmr.NerfMeshRenderer))
    monkeypatch.setattr(pynmr_torch, "NerfMeshRenderer",
                        _with_overrides(pynmr_torch.NerfMeshRenderer))
    jr = japp.run(snapshot_path, quad, G_LEFT, G_RIGHT,
                  landmark_fn=landmark_fn, reference_landmarks=REFERENCE,
                  max_frames=3)
    tr = tapp.run(snapshot_path, quad, G_LEFT, G_RIGHT,
                  landmark_fn=landmark_fn, reference_landmarks=REFERENCE,
                  max_frames=3)
    assert tr.device.type == "cpu" and tr._envmap is None
    jnode, tnode = jr._meshes[0].nodes[0], tr._meshes[0].nodes[0]
    for attr in ("translation", "scale", "rotation"):
        np.testing.assert_allclose(getattr(tnode, attr), getattr(jnode, attr),
                                   atol=1e-4)
    t, s, r = placement.compute_glasses_placement(
        [GT[i] for i in placement.LANDMARK_ORDER], G_LEFT, G_RIGHT)
    np.testing.assert_allclose(tnode.translation, t, atol=5e-3)
    np.testing.assert_allclose(tnode.scale, s, rtol=0.05)
    np.testing.assert_array_equal(tr.view_projection_mat,
                                  jr.view_projection_mat)
    assert tr.stats()["frame_count"] == jr.stats()["frame_count"]
    assert tr.stats()["n_meshes"] == 1
    assert int((tr._nerfs[0]._surface_t > 0).sum()) > 0     # mesh pixels
    assert psnr(tr.display_image()[..., :3], jr.display_image()[..., :3]) >= 50.0
    assert tr.app_report["sweep_frames"] > 60
    assert tr.app_report["sweep_s"] > 0
    assert tr.app_report["orbit_ms_per_frame"] > 0
    assert "avg frame time [ms]:" in capsys.readouterr().out


def test_run_surfaces_envmap_errors(snapshot_path, tmp_path, monkeypatch):
    """Only a missing envmap file is passed over."""
    monkeypatch.setattr(tapp, "DEVICE", "cpu")

    def broken(self, path):
        raise ValueError("not an image")

    monkeypatch.setattr(pynmr_torch.NerfMeshRenderer, "envmap", broken)
    with pytest.raises(ValueError, match="not an image"):
        tapp.run(snapshot_path, "none.gltf", G_LEFT, G_RIGHT,
                 landmark_fn=landmark_fn, reference_landmarks=REFERENCE,
                 max_frames=1)


def test_run_needs_a_landmark_provider(snapshot_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tapp, "DEVICE", "cpu")
    monkeypatch.setattr(tapp, "_mediapipe_face_mesh", lambda: None)
    with pytest.raises(RuntimeError, match="mediapipe"):
        tapp.run(snapshot_path, "none.gltf", G_LEFT, G_RIGHT)


def test_render_image_matches_jax(snapshot_path, monkeypatch):
    for app in (japp, tapp):
        monkeypatch.setattr(app, "W", W)
        monkeypatch.setattr(app, "H", H)
    (_, jn), (_, tn) = _app_renderers(snapshot_path)
    for n in (jn, tn):
        n.march_overrides = {**OVERRIDES, "max_rounds": 96}
    im_j, im_t = japp.render_image(jn), tapp.render_image(tn)
    assert im_t.shape == (H, W, 3) and im_t.dtype == np.uint8
    assert im_t.flags["C_CONTIGUOUS"]
    assert np.abs(im_t.astype(int) - im_j.astype(int)).max() <= 1
    assert im_t.std() > 1.0


def test_detect_landmarks_mediapipe_shapes():
    class Point:
        def __init__(self, v):
            self.x, self.y, self.z = v

    class Result:
        def __init__(self, faces):
            self.multi_face_landmarks = faces

    class Face:
        landmark = [Point((0.1 * i, 0.2, 0.3)) for i in range(5)]

    class Mesh:
        def __init__(self, faces):
            self.faces = faces

        def process(self, image):
            return Result(self.faces)

    img = np.zeros((4, 4, 3), np.uint8)
    assert tapp.detect_landmarks_mediapipe(Mesh([]), img) is None
    out = tapp.detect_landmarks_mediapipe(Mesh([Face()]), img)
    np.testing.assert_array_equal(
        out, japp.detect_landmarks_mediapipe(Mesh([Face()]), img))
    assert out.shape == (5, 3) and out.dtype == np.float32


@pytest.mark.parametrize("argv", [["render_app", "-h"],
                                  ["render_app", "-n", "x.msgpack"]],
                         ids=["help", "missing_arguments"])
def test_main_prints_help(argv, capsys):
    assert tapp.main(argv) is None
    out = capsys.readouterr().out
    assert "nerf_glasses_tpu_torch.apps.render_app" in out and "--mesh" in out


def test_main_parses_the_reference_command_line(monkeypatch):
    got = {}
    monkeypatch.setattr(tapp, "run", lambda *a: got.update(args=a))
    tapp.main(["render_app", "-n", "n.msgpack", "-m", "g.gltf",
               "-l", "-0.732 -1.002 -0.057", "-r", "0.732 -1.002 -0.057"])
    nerf_file, mesh_file, left, right = got["args"]
    assert (nerf_file, mesh_file) == ("n.msgpack", "g.gltf")
    np.testing.assert_allclose(left, [-0.732, -1.002, -0.057])
    np.testing.assert_allclose(right, [0.732, -1.002, -0.057])

"""End-to-end glasses placement + orbit render loop.

Port of nerf_glasses_tpu/apps/render_app.py, the reference application
volume/render.py (same CLI, same flow): find a camera view where
MediaPipe detects the face, sweep viewpoints collecting landmark rays,
midpoint-triangulate 3D landmarks, auto-place the glasses mesh, then
orbit-render forever printing the average frame time every 10 s
(volume/render.py:226-261). It drives the port through pynmr_torch, on
DEVICE.

MediaPipe is an optional dependency: when unavailable, a synthetic
landmark provider can be injected for testing (`landmark_fn`).

Usage:
  python -m nerf_glasses_tpu_torch.apps.render_app -n nerf.msgpack \\
      -m glasses.gltf -l "-0.732 -1.002 -0.057" -r "0.732 -1.002 -0.057"
"""

from __future__ import annotations

import getopt
import sys
import time

import numpy as np
import torch

from nerf_glasses_tpu_torch.utils import placement

HELP = """
Usage: python -m nerf_glasses_tpu_torch.apps.render_app -n <msgpack> \\
        -m <gltf> -l <left temple vertex> -r <right temple vertex>

  -n, --nerf          Trained NeRF snapshot (.msgpack)
  -m, --mesh          Glasses mesh (glTF); base must be at (0, 0, 0)
  -l, --left_temple   Left temple vertex "x y z"
  -r, --right_temple  Right temple vertex "x y z"
"""

W = 1280
H = 720
DEVICE = "cuda"
# angle step of the landmark sweep over [0, pi): 63 views at the
# reference's 0.05 (render.py:147); a coarser step is a shorter sweep
SWEEP_STEP = 0.05


def _mediapipe_face_mesh():
    try:
        import mediapipe as mp
    except ImportError:
        return None
    return mp.solutions.face_mesh.FaceMesh(
        static_image_mode=True, max_num_faces=1, refine_landmarks=True,
        min_detection_confidence=0.5)


def render_image(nerf):
    """render.py:64-67: render, flip vertically, channel-swap for
    MediaPipe (expects RGB uint8)."""
    im = np.uint8(np.clip(nerf.render(W, H, linear=False), 0, 1) * 255)
    return im[::-1, :, :3][..., ::-1].copy()


def detect_landmarks_mediapipe(face_mesh, image) -> np.ndarray | None:
    res = face_mesh.process(image)
    if not res.multi_face_landmarks:
        return None
    lms = res.multi_face_landmarks[0].landmark
    return np.array([[p.x, p.y, p.z] for p in lms], np.float32)


def rotate_camera_to_face_face(renderer, nerf, landmark_fn,
                               reference_landmarks, max_tries=200):
    """Brute-force orbit until the face is detected, then orient the
    camera to face it (render.py:69-94)."""
    i = 0
    while renderer.frame() and i < max_tries:
        lms = landmark_fn(renderer, nerf)
        if lms is None:
            i += 1
            renderer.orbit(0.1, 0, np.sin(i))
            continue
        d_az, d_po = placement.estimate_face_orientation(
            reference_landmarks, lms)
        renderer.orbit(d_az, d_po, 0)
        return True
    return False


def find_3d_landmarks(renderer, nerf, landmark_fn, reference_landmarks):
    """Viewpoint sweep + midpoint triangulation (render.py:122-186)."""
    rotate_camera_to_face_face(renderer, nerf, landmark_fn,
                               reference_landmarks)

    rays_per_landmark = [[] for _ in placement.LANDMARK_ORDER]

    renderer.orbit(np.deg2rad(60), np.deg2rad(-15), 0)
    renderer.orbit(0, 0, 2)
    renderer.orbit(-np.pi / 2, 0, 0)
    renderer.frame()

    step = SWEEP_STEP
    for i in np.arange(0, np.pi, step):
        polar_step = step * np.deg2rad(40 / 2)
        azimuth_step = step * np.deg2rad(60 / 2)
        renderer.orbit(np.sin(i * 3) * azimuth_step * 3,
                       np.sin(i) * polar_step, 0)
        renderer.frame()
        lms = landmark_fn(renderer, nerf)
        if lms is None:
            continue
        transform = renderer.view_projection_mat
        for k, lm_id in enumerate(placement.LANDMARK_ORDER):
            rays_per_landmark[k].append(
                placement.LandmarkRay(transform, lms[lm_id][0],
                                      lms[lm_id][1]))

    print(len(rays_per_landmark[0]))
    return [placement.closest_point_between_rays(rays)
            for rays in rays_per_landmark]


def place_glasses(renderer, file_path, landmarks, glasses_left,
                  glasses_right):
    t, s, r = placement.compute_glasses_placement(landmarks, glasses_left,
                                                  glasses_right)
    print("t=", t, "s=", s, "r=", r)
    return renderer.load_mesh(file_path, t=t, s=s, r=r)


def _drained_clock(renderer) -> float:
    """The host clock after the device finished what was enqueued."""
    if renderer.device.type == "cuda":
        torch.cuda.synchronize(renderer.device)
    return time.time()


def run(nerf_file, mesh_file, glasses_left, glasses_right,
        landmark_fn=None, reference_landmarks=None, max_frames=None):
    """The application -> the renderer, after max_frames orbit frames
    (never, when max_frames is None).

    "avg frame time [ms]" is the host clock over the frames since the last
    report, read after draining the device at the report (every 10 s, and
    at max_frames); frame() itself only enqueues, and the loop fetches no
    pixels. The renderer carries what the run measured in `app_report`:
    the landmark sweep's seconds and frames, the triangulated landmarks
    and the last reported average."""
    import pynmr_torch as nmr
    renderer = nmr.NerfMeshRenderer(W, H, device=DEVICE)
    try:
        renderer.envmap("sunflowers_puresky_1k.png")
    except FileNotFoundError:
        pass    # the reference script names a file it does not ship

    nerf = renderer.load_nerf(nerf_file)
    nerf.render_aabb.min = np.array([-0.2, 0.15, -0.2], np.float32)
    nerf.render_aabb.max = np.array([1, 1, 1], np.float32)

    if landmark_fn is None:
        face_mesh = _mediapipe_face_mesh()
        if face_mesh is None:
            raise RuntimeError(
                "mediapipe is not available; pass landmark_fn= for "
                "headless placement")

        def landmark_fn(r, n):
            return detect_landmarks_mediapipe(face_mesh, render_image(n))

    if reference_landmarks is None:
        reference_landmarks = np.load("reference_landmarks.npy")

    print("Finding 3d face landmarks...")
    t0 = _drained_clock(renderer)
    landmarks = find_3d_landmarks(renderer, nerf, landmark_fn,
                                  reference_landmarks)
    renderer.app_report = dict(sweep_s=_drained_clock(renderer) - t0,
                               sweep_frames=renderer.stats()["frame_count"],
                               landmarks=landmarks)
    place_glasses(renderer, mesh_file, landmarks, glasses_left,
                  glasses_right)

    a = 0.0
    t0 = _drained_clock(renderer)
    frames = total = 0
    while renderer.frame():
        a += 0.03
        renderer.orbit(-np.sin(a * 1.733) / 100, np.cos(a * 1.733) / 200, 0)
        frames += 1
        total += 1
        # max_frames bounds the whole loop, not the frames since the last
        # report (the JAX app restarts its count at every report)
        done = max_frames is not None and total >= max_frames
        if done or time.time() - t0 >= 10:
            now = _drained_clock(renderer)
            avg_ms = (now - t0) / frames * 1000
            renderer.app_report["orbit_ms_per_frame"] = avg_ms
            print("avg frame time [ms]:", avg_ms)
            t0 = now
            frames = 0
        if done:
            break
    return renderer


def main(argv=None):
    opts, _ = getopt.getopt(
        (argv or sys.argv)[1:], "hn:m:l:r:",
        ["nerf=", "mesh=", "left_temple=", "right_temple="])
    nerf_file = mesh_file = glasses_left = glasses_right = None
    for opt, arg in opts:
        if opt == "-h":
            print(HELP)
            return
        elif opt in ("-n", "--nerf"):
            nerf_file = arg
        elif opt in ("-m", "--mesh"):
            mesh_file = arg
        elif opt in ("-l", "--left_temple"):
            glasses_left = np.fromstring(arg, dtype=float, sep=" ")
        elif opt in ("-r", "--right_temple"):
            glasses_right = np.fromstring(arg, dtype=float, sep=" ")
    if any(v is None for v in (nerf_file, mesh_file, glasses_left,
                               glasses_right)):
        print(HELP)
        return
    run(nerf_file, mesh_file, glasses_left, glasses_right)


if __name__ == "__main__":
    main()

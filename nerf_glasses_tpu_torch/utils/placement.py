"""Glasses auto-placement math: landmark triangulation, Procrustes/Kabsch
alignment, plane intersection.

Port of nerf_glasses_tpu/utils/placement.py: pure numpy, the
application-layer math of the reference's volume/render.py
(align_point_sets :39, kabsch :52,
Ray.closest / closest_point_between_rays :97-119,
line_plane_intersection :188, place_glasses :194). These are the
testable, deterministic pieces of the MediaPipe placement flow; the
MediaPipe detector itself is an optional runtime dependency (gated in
apps/render_app.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from nerf_glasses_tpu_torch.utils.quat import quat_from_mat3

# MediaPipe face-mesh landmark indices used for placement
# (volume/render.py:172-180)
LANDMARK_IDS = {
    "nose_0": 6, "nose_1": 197, "nose_2": 195,
    "temple_left": 162, "temple_right": 389,
    "temple_lower_left": 127, "temple_lower_right": 356,
    "eye_left": 33, "eye_right": 263,
}
LANDMARK_ORDER = [6, 197, 195, 162, 389, 127, 356, 33, 263]


def align_point_sets(P: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Rigid transform (4x4) aligning centered P onto K via SVD."""
    centroid_p = P.mean(axis=0)
    centroid_k = K.mean(axis=0)
    u, _, vt = np.linalg.svd((P - centroid_p).T @ (K - centroid_k))
    rot = u @ vt
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = centroid_k - rot @ centroid_p
    return out


def kabsch_quaternion(P: Sequence[np.ndarray], K: Sequence[np.ndarray]):
    """Optimal rotation P->K as a (w, x, y, z) quaternion (Kabsch with
    reflection fix)."""
    cov = np.zeros((3, 3))
    for p, k in zip(P, K):
        cov += np.outer(p, k)
    u, _, vt = np.linalg.svd(cov)
    rot = vt.T @ u.T
    if np.linalg.det(rot) < 0:
        ref = np.diag([1.0, 1.0, -1.0])
        rot = vt.T @ ref @ u.T
    return quat_from_mat3(rot)


class LandmarkRay:
    """A viewing ray through a MediaPipe screen-space landmark.

    The landmark's (x, y) in [0,1] maps to the packed camera's NDC as
    (2x-1, -2y+1, 1): MediaPipe y is top-down while the camera v axis
    points up (Ray.__init__, volume/render.py:98-101)."""

    def __init__(self, cam_transform: np.ndarray, lm_x: float, lm_y: float):
        cam = np.asarray(cam_transform, np.float64)
        self.origin = cam[:, 3].copy()
        self.dir = cam[:, :3] @ np.array(
            [2 * lm_x - 1, -2 * lm_y + 1, 1.0])

    def closest(self, other: "LandmarkRay") -> np.ndarray:
        """Point on this ray closest to `other`."""
        A, a = self.origin, self.dir
        B, b = other.origin, other.dir
        c = B - A
        denom = a.dot(a) * b.dot(b) - a.dot(b) ** 2
        return A + a * (-a.dot(b) * b.dot(c) + a.dot(c) * b.dot(b)) / denom


def closest_point_between_rays(rays: List[LandmarkRay]) -> np.ndarray:
    """Midpoint triangulation over all ray pairs
    (volume/render.py:112-119)."""
    pairs = [(a, b) for i, a in enumerate(rays) for b in rays[i + 1:]]
    acc = np.zeros(3)
    for a, b in pairs:
        acc += a.closest(b) + b.closest(a)
    return acc / (len(pairs) * 2)


def line_plane_intersection(line_p1, line_p2, plane_p, plane_n) -> np.ndarray:
    line_p1 = np.asarray(line_p1, np.float64)
    line_d = np.asarray(line_p2, np.float64) - line_p1
    t = np.dot(plane_n, np.asarray(plane_p) - line_p1) / np.dot(plane_n, line_d)
    return line_p1 + t * line_d


def compute_glasses_placement(landmarks: Sequence[np.ndarray],
                              glasses_left: np.ndarray,
                              glasses_right: np.ndarray):
    """From 9 triangulated 3D landmarks (LANDMARK_ORDER) and the glasses
    mesh's temple vertices, compute (t, s, r) for load_mesh
    (place_glasses, volume/render.py:194-224). r is (w, x, y, z)."""
    landmarks = [np.asarray(p, np.float64) for p in landmarks]
    eye_l, eye_r = landmarks[7], landmarks[8]
    eye_vec = eye_l - eye_r
    eye_dist = np.linalg.norm(eye_vec)
    eye_vec = eye_vec / eye_dist
    forward_vec = np.cross(eye_vec, [0.0, 1.0, 0.0])
    normal_vec = np.cross(eye_vec, forward_vec)
    normal_vec = normal_vec / np.linalg.norm(normal_vec)

    left_proj = (line_plane_intersection(landmarks[5], landmarks[3], eye_l,
                                         normal_vec)
                 + forward_vec * eye_dist * 0.5)
    right_proj = (line_plane_intersection(landmarks[6], landmarks[4], eye_l,
                                          normal_vec)
                  + forward_vec * eye_dist * 0.5)

    temple_dist = np.linalg.norm(landmarks[3] - landmarks[4])
    glasses_dist = np.linalg.norm(np.asarray(glasses_left)
                                  - np.asarray(glasses_right))
    scale = temple_dist / glasses_dist

    rot = kabsch_quaternion(
        [np.asarray(glasses_left), np.asarray(glasses_right)],
        [(left_proj - landmarks[0]) / scale,
         (right_proj - landmarks[0]) / scale])

    t = landmarks[0]
    s = np.array([scale, scale, scale])
    return t, s, rot


def estimate_face_orientation(reference_landmarks: np.ndarray,
                              detected_landmarks: np.ndarray):
    """-> (azimuth, polar) orbit deltas to face the face
    (rotate_camera_to_face_face, volume/render.py:86-93)."""
    transform = align_point_sets(reference_landmarks, detected_landmarks)
    azimuth = np.arctan2(transform[0, 2], transform[0, 0])
    polar = np.arctan2(transform[2, 2], transform[1, 2]) - np.pi / 2
    return -azimuth, polar

"""Cameras: orbital camera, look-to view, and the packed iNGP-style
3x4 camera matrix used by both render passes.

Reference semantics:
  orbitcam                    src/orbit_camera.h:7-77
  flythrough_camera_look_to   dependencies/flythrough_camera.h:256-334
  updateModelViewProj         src/nerf_mesh_renderer.cu:919-939
    cols = [right * uLength, up * vLength, forward, eye] with
    vLength = tanf(0.5f * 45)  — NOTE: radians, i.e. tan(22.5 rad), a
    reference quirk preserved for pixel-exact camera parity —
    uLength = vLength * aspect.
  fov_to_focal_length         src/ngp/ngp_common.cuh:121-123
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# The reference's tanf(0.5f * 45) with 45 interpreted as radians.
V_LENGTH_QUIRK = math.tan(0.5 * 45.0)


def fov_to_focal_length(resolution: int, degrees: float) -> float:
    return 0.5 * resolution / math.tan(0.5 * degrees * math.pi / 180.0)


def look_to(eye: np.ndarray, look: np.ndarray, up: np.ndarray):
    """-> (right, up', forward) orthonormal camera basis (right-handed)."""
    f = np.asarray(look, np.float64)
    f = f / np.linalg.norm(f)
    upn = np.asarray(up, np.float64)
    upn = upn / np.linalg.norm(upn)
    s = np.cross(f, upn)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    u = u / np.linalg.norm(u)
    return s.astype(np.float32), u.astype(np.float32), f.astype(np.float32)


def pack_camera(right: np.ndarray, up: np.ndarray, forward: np.ndarray,
                eye: np.ndarray, aspect: float,
                v_length: float = V_LENGTH_QUIRK) -> np.ndarray:
    """Build the 3x4 packed camera matrix (updateModelViewProj)."""
    m = np.zeros((3, 4), np.float32)
    m[:, 0] = right * (v_length * aspect)
    m[:, 1] = up * v_length
    m[:, 2] = forward
    m[:, 3] = eye
    return m


@dataclass
class OrbitCamera:
    """Orbital camera around a pivot (orbit_camera.h:7-77)."""
    eye: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 2.0], np.float32))
    pivot: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    look: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1e-6, -0.999999], np.float32))

    def orbit(self, delta_azimuth: float, delta_polar: float, delta_zoom: float):
        d = self.eye - self.pivot
        radius = float(np.linalg.norm(d))
        d = d / radius
        azimuth = math.atan2(d[2], d[0])
        polar = math.atan2(d[1], math.hypot(d[0], d[2]))

        azimuth = math.fmod(azimuth + delta_azimuth, 2 * math.pi)
        if azimuth < 0.0:
            azimuth += 2 * math.pi

        polar_cap = math.pi / 2 - 0.001
        polar = min(polar_cap, max(-polar_cap, polar + delta_polar))

        radius -= delta_zoom * radius * 0.1
        radius = max(radius, 1.0)

        ca, sa = math.cos(azimuth), math.sin(azimuth)
        cp, sp = math.cos(polar), math.sin(polar)
        self.eye = self.pivot + radius * np.array([cp * ca, sp, cp * sa], np.float32)
        self.look = (self.pivot - self.eye).astype(np.float32)
        self.look /= np.linalg.norm(self.look)

    def basis(self):
        return look_to(self.eye, self.look, self.up)

    def packed(self, aspect: float) -> np.ndarray:
        s, u, f = self.basis()
        return pack_camera(s, u, f, self.eye.astype(np.float32), aspect)

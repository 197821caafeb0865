"""Posed, calibrated cameras (host-side numpy), as in tpugs/core/camera.py.

The per-view quantities handed to the render path are a 4x4 world->camera
matrix and the intrinsics (fx, fy, cx, cy).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraInfo:
    """One posed, calibrated view (COLMAP convention: X right, Y down, Z
    forward)."""

    image_name: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    R: np.ndarray  # [3,3] world->camera rotation
    t: np.ndarray  # [3]   world->camera translation
    image_path: str = ""
    camera_id: int = -1

    def world_to_camera(self) -> np.ndarray:
        """4x4 [R|t; 0 1]."""
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = self.R
        m[:3, 3] = self.t
        return m

    def camera_center(self) -> np.ndarray:
        """-R^T t."""
        return -self.R.T @ self.t

    def intrinsics_array(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)

"""Posed, calibrated cameras (host-side numpy), as in tpugs/core/camera.py.

The per-view quantities handed to the render path are a 4x4 world->camera
matrix and the intrinsics (fx, fy, cx, cy).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class CameraModel(enum.IntEnum):
    """COLMAP camera model ids."""

    SIMPLE_PINHOLE = 0
    PINHOLE = 1
    SIMPLE_RADIAL = 2
    RADIAL = 3
    OPENCV = 4


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation (float64)."""
    w, x, y, z = [float(v) for v in qvec]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


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

    def scaled(self, scale: float) -> "CameraInfo":
        """Resolution and intrinsics divided by `scale`."""
        return dataclasses.replace(
            self,
            width=int(round(self.width / scale)),
            height=int(round(self.height / scale)),
            fx=self.fx / scale,
            fy=self.fy / scale,
            cx=self.cx / scale,
            cy=self.cy / scale,
        )

    def intrinsics_array(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)

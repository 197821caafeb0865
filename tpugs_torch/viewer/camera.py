"""Orbit camera controller, as in tpugs/viewer/camera.py.

Azimuth/elevation/radius orbit around a target; initialised from point
percentiles (median center, 5-95% extent); builds COLMAP-convention cameras
(X right, Y down, Z forward) with intrinsics from a vertical FOV.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tpugs_torch.core.camera import CameraInfo


@dataclasses.dataclass
class OrbitCamera:
    target: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    radius: float = 5.0
    azimuth: float = 0.0  # radians, around +Y
    elevation: float = 0.0  # radians, up from the horizontal plane
    fov_y_deg: float = 60.0
    _version: int = 0

    @staticmethod
    def from_points(points: np.ndarray, fov_y_deg: float = 60.0) -> "OrbitCamera":
        """Median center + 5-95 percentile extent."""
        if len(points) == 0:
            return OrbitCamera(fov_y_deg=fov_y_deg)
        center = np.median(points, axis=0)
        lo = np.percentile(points, 5, axis=0)
        hi = np.percentile(points, 95, axis=0)
        extent = float(np.max(hi - lo))
        return OrbitCamera(
            target=center.astype(np.float64),
            radius=max(extent * 1.5, 1e-3),
            fov_y_deg=fov_y_deg,
        )

    def rotate(self, d_azimuth: float, d_elevation: float):
        self.azimuth += d_azimuth
        self.elevation = float(
            np.clip(self.elevation + d_elevation, -1.45, 1.45))
        self._version += 1

    def pan(self, dx: float, dy: float):
        """Pan in the camera's right/up plane, scaled by the radius."""
        fwd = self._forward()
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right) + 1e-12
        up = np.cross(right, fwd)
        self.target = self.target + (right * dx + up * dy) * self.radius
        self._version += 1

    def zoom(self, factor: float):
        self.radius = float(np.clip(self.radius * factor, 1e-3, 1e6))
        self._version += 1

    def version(self) -> int:
        """Counts the moves: a viewer re-renders when it changed."""
        return self._version

    def _forward(self) -> np.ndarray:
        """Unit vector from eye toward target."""
        ce, se = np.cos(self.elevation), np.sin(self.elevation)
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        # Eye offset from target (Y-down world like COLMAP: elevation lifts -Y).
        offset = np.array([ce * sa, -se, -ce * ca]) * self.radius
        return -offset / (np.linalg.norm(offset) + 1e-12)

    def eye(self) -> np.ndarray:
        return self.target - self._forward() * self.radius

    def build_camera(self, width: int, height: int) -> CameraInfo:
        """COLMAP-convention CameraInfo."""
        z = self._forward()
        world_up = np.array([0.0, -1.0, 0.0])
        x = np.cross(world_up, z)
        n = np.linalg.norm(x)
        if n < 1e-6:
            x = np.array([1.0, 0.0, 0.0])
        else:
            x /= n
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)  # rows = camera axes in world
        t = -R @ self.eye()
        fy = 0.5 * height / np.tan(np.radians(self.fov_y_deg) / 2)
        return CameraInfo(image_name="orbit", width=width, height=height,
                          fx=fy, fy=fy, cx=width / 2.0, cy=height / 2.0,
                          R=R, t=t)


def orbit_trajectory(points: np.ndarray, num_frames: int, width: int, height: int,
                     elevation_deg: float = 15.0, fov_y_deg: float = 60.0):
    """A full orbit around the scene, as a list of CameraInfo."""
    cam = OrbitCamera.from_points(points, fov_y_deg)
    cam.elevation = np.radians(elevation_deg)
    frames = []
    for i in range(num_frames):
        cam.azimuth = 2 * np.pi * i / num_frames
        frames.append(cam.build_camera(width, height))
    return frames

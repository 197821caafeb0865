"""Dataset: a COLMAP scene, its images, the train/test split and the scene
bounds, as in tpugs/data/dataset.py:

- finds `sparse/0/` or `sparse/`;
- cameras sorted by image name; every 8th image is a test view;
- resolution_scale divides image sizes and intrinsics, reading
  `images_<scale>/` where it exists, else `images/`;
- images load lazily per access, resized to the camera;
- bounds over the sparse points and camera centres, extent = the largest
  half-extent.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from tpugs_torch.core.camera import CameraInfo
from tpugs_torch.data import colmap
from tpugs_torch.data.image_io import load_image_resized

TEST_EVERY = 8


@dataclasses.dataclass
class SceneBounds:
    min: np.ndarray
    max: np.ndarray
    center: np.ndarray
    extent: float


def compute_scene_bounds(points: np.ndarray,
                         cam_centers: np.ndarray) -> SceneBounds:
    all_pts = (points if cam_centers.size == 0
               else np.concatenate([points, cam_centers], 0))
    mn = all_pts.min(axis=0)
    mx = all_pts.max(axis=0)
    center = 0.5 * (mn + mx)
    extent = float(np.max(0.5 * (mx - mn)))
    return SceneBounds(mn, mx, center, extent)


class Dataset:
    def __init__(self, root: str, resolution_scale: int = 1):
        self.root = root
        self.resolution_scale = resolution_scale

        sparse = os.path.join(root, "sparse", "0")
        if not os.path.isdir(sparse):
            sparse = os.path.join(root, "sparse")
        if not os.path.isdir(sparse):
            raise FileNotFoundError(f"no COLMAP sparse dir under {root}")

        cams, images, xyz, rgb = colmap.parse_colmap_sparse(sparse)
        self.points_xyz = xyz.astype(np.float32)
        self.points_rgb = rgb.astype(np.float32) / 255.0

        infos = colmap.merge_cameras_images(cams, images)
        infos.sort(key=lambda c: c.image_name)

        img_dir = os.path.join(root, f"images_{resolution_scale}")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(root, "images")
        self.image_dir = img_dir

        scaled: list[CameraInfo] = []
        for info in infos:
            if resolution_scale > 1:
                info = info.scaled(resolution_scale)
            info.image_path = os.path.join(self.image_dir, info.image_name)
            scaled.append(info)

        self.train_cameras: list[CameraInfo] = []
        self.test_cameras: list[CameraInfo] = []
        for i, info in enumerate(scaled):
            (self.test_cameras if i % TEST_EVERY == 0
             else self.train_cameras).append(info)

        centers = (np.stack([c.camera_center() for c in scaled], 0)
                   if scaled else np.zeros((0, 3)))
        self.scene_bounds = compute_scene_bounds(self.points_xyz,
                                                 centers.astype(np.float32))

    def num_train(self) -> int:
        return len(self.train_cameras)

    def num_test(self) -> int:
        return len(self.test_cameras)

    def load_train_image(self, idx: int) -> np.ndarray:
        return self._load(self.train_cameras[idx])

    def load_test_image(self, idx: int) -> np.ndarray:
        return self._load(self.test_cameras[idx])

    def _load(self, cam: CameraInfo) -> np.ndarray:
        return load_image_resized(cam.image_path, cam.width, cam.height)

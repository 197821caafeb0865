"""Synthetic ground-truth scenes, as in tpugs/utils/gt_scene.py: a known
gaussian model rendered from an orbit into a COLMAP dataset (cameras.bin,
images.bin, points3D.bin and PNGs), so training can be driven end to end
without outside data. The same numpy draws as the reference give the same
model, cameras and sparse points from a seed.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch
from PIL import Image

from tpugs_torch.core.sh import SH_C0, rgb_to_sh_dc
from tpugs_torch.data.colmap import POINT_RECORD
from tpugs_torch.device import resolve_device
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.viewer.camera import OrbitCamera

# The reference's fixed raster configuration for the target images: with
# many gaussians it truncates them as the reference does; they are only
# targets.
GT_RASTER = dict(tile_h=16, tile_w=16, pair_capacity=1 << 19,
                 max_hits_per_tile=1024)


def make_gt_model(n: int = 8000, seed: int = 0, sh_coeffs: int = 16,
                  device="cuda") -> dict:
    """Many small clustered blobs with per-gaussian colour detail, as float32
    tensors on `device` ('cuda' unless 'cpu' is asked for)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_clusters = max(16, n // 60)
    centers = rng.uniform(-1.0, 1.0, (n_clusters, 3)) * np.array([1.2, 0.6, 1.2])
    cluster_colors = rng.uniform(0.1, 0.9, (n_clusters, 3))
    which = rng.integers(0, n_clusters, n)

    means = centers[which] + rng.normal(0, 0.08, (n, 3))
    colors = np.clip(
        cluster_colors[which] + rng.normal(0, 0.15, (n, 3)), 0.02, 0.98
    )
    sh = torch.zeros((n, 3, sh_coeffs), dtype=torch.float32)
    sh[:, :, 0] = rgb_to_sh_dc(torch.from_numpy(colors.astype(np.float32)))
    if sh_coeffs > 1:  # mild view dependence in band 1
        sh[:, :, 1:4] = torch.from_numpy(
            rng.normal(0, 0.04, (n, 3, 3)).astype(np.float32))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return {
        "means": f32(means),
        "quats": f32(rng.normal(size=(n, 4))),
        "log_scales": f32(np.log(rng.uniform(0.004, 0.018, (n, 3)))),
        "opacity_logits": f32(rng.uniform(0.0, 3.0, n)),
        "sh": sh.to(device),
    }


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return np.array([
        w,
        (R[2, 1] - R[1, 2]) / (4 * w + 1e-12),
        (R[0, 2] - R[2, 0]) / (4 * w + 1e-12),
        (R[1, 0] - R[0, 1]) / (4 * w + 1e-12),
    ])


def write_gt_dataset(root: str, model: dict, num_views: int = 24,
                     width: int = 488, height: int = 272,
                     radius: float = 3.2, elevation_deg: float = 18.0,
                     sparse_points: int = 1500, seed: int = 1,
                     sh_degree: int = 1, jitter: float = 0.0,
                     elevation_rings: int = 1):
    """Render `model` (tensors on one device) from an orbit and write a
    complete COLMAP dataset under `root`. jitter > 0 perturbs each view's
    azimuth, elevation and radius; elevation_rings > 1 alternates orbit
    heights. Returns [(image name, CameraInfo)]."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    images_dir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)

    cfg = RasterConfig(img_h=height, img_w=width, **GT_RASTER)
    dev = model["means"].device
    n = model["means"].shape[0]
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    bg = torch.zeros((3,), device=dev)

    def render_view(viewmat, intr):
        out = render(model["means"], model["quats"], model["log_scales"],
                     model["opacity_logits"], model["sh"], alive, viewmat,
                     intr, cfg, sh_degree, bg, need_grads=False)
        return torch.clamp(out.color, 0.0, 1.0)

    cam = OrbitCamera(
        target=torch.mean(model["means"], dim=0).cpu().numpy(),
        radius=radius,
        fov_y_deg=50.0,
    )
    cam.elevation = np.radians(elevation_deg)

    infos = []
    base_el = np.radians(elevation_deg)
    ring_els = [base_el + np.radians(24.0) * r for r in range(elevation_rings)]
    for i in range(num_views):
        spacing = 2 * np.pi / num_views
        cam.azimuth = spacing * i + jitter * rng.uniform(-0.5, 0.5) * spacing
        cam.elevation = (
            ring_els[i % elevation_rings]
            + jitter * np.radians(12.0) * rng.uniform(-1, 1)
        )
        cam.radius = radius * (1.0 + jitter * 0.08 * rng.uniform(-1, 1))
        info = cam.build_camera(width, height)
        img = render_view(
            torch.as_tensor(info.world_to_camera(), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(info.intrinsics_array(), device=dev),
        ).cpu().numpy()
        name = f"render_{i:03d}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(images_dir, name)
        )
        infos.append((name, info))

    fx = infos[0][1].fx
    cx, cy = width / 2.0, height / 2.0
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, width, height))
        f.write(np.asarray([fx, fx, cx, cy], "<f8").tobytes())

    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(infos)))
        for i, (name, info) in enumerate(infos):
            f.write(struct.pack("<i", i + 1))
            f.write(np.asarray(_rotmat_to_qvec(info.R), "<f8").tobytes())
            f.write(np.asarray(info.t, "<f8").tobytes())
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))

    # Sparse points: a noisy subsample of the true means (SfM-like input),
    # one packed record each with an empty track.
    means = model["means"].cpu().numpy()
    sh0 = model["sh"][:, :, 0].cpu().numpy()
    colors = np.clip(sh0 * SH_C0 + 0.5, 0, 1)
    sel = rng.choice(n, min(sparse_points, n), replace=False)
    pts = means[sel] + rng.normal(0, 0.01, (len(sel), 3))
    rec = np.zeros(len(sel), POINT_RECORD)
    rec["id"] = np.arange(len(sel))
    rec["xyz"] = pts
    rec["rgb"] = (colors[sel] * 255).astype(np.uint8)
    rec["error"] = 0.5
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(sel)))
        f.write(rec.tobytes())

    return infos

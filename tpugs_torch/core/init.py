"""Gaussian initialisation from SfM sparse points, as in tpugs/core/init.py:
position = point, SH DC from the point colour (higher bands zero), opacity
inverse_sigmoid(0.1), identity rotation, and an isotropic log scale of the
mean distance to the 3 nearest neighbours (at least 1e-7).
"""
from __future__ import annotations

import numpy as np
import torch

from tpugs_torch.core import sh as sh_lib
from tpugs_torch.core.gaussians import GaussianState, inverse_sigmoid
from tpugs_torch.device import resolve_device

INIT_OPACITY = 0.1
KNN_K = 3
MIN_SCALE = 1e-7
KNN_BLOCK_ELEMS = 1 << 28  # [block, N] distance elements per query block


def mean_knn_distance(points: torch.Tensor, k: int = KNN_K,
                      block: int | None = None) -> torch.Tensor:
    """Mean distance from each point to its k nearest other points.

    Blocked O(N^2): each block of queries takes its squared distances to
    all points elementwise, (dx^2 + dy^2) + dz^2, so a point's result does
    not depend on the block, and keeps the k + 1 smallest (the first is the
    point itself). The default block keeps the [block, N] matrix near
    KNN_BLOCK_ELEMS elements (1 GB at float32)."""
    n = points.shape[0]
    k_eff = min(k, max(n - 1, 1))
    if block is None:
        block = max(1, KNN_BLOCK_ELEMS // max(n, 1))
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    for s in range(0, n, block):
        q = points[s:s + block]
        d2 = torch.sub(q[:, 0:1], px).square_()
        d2.add_(torch.sub(q[:, 1:2], py).square_())
        d2.add_(torch.sub(q[:, 2:3], pz).square_())
        top = torch.topk(d2, min(k_eff + 1, n), dim=1, largest=False).values
        dists = torch.sqrt(torch.clamp(top[:, 1:], min=0.0))
        out[s:s + block] = torch.mean(dists, dim=-1)
    return out


def init_from_sfm(points_xyz: np.ndarray, points_rgb: np.ndarray,
                  capacity: int, max_sh_degree: int = 3,
                  max_points: int | None = None,
                  device="cuda") -> GaussianState:
    """A capacity-padded GaussianState on `device` ('cuda' unless 'cpu' is
    asked for) from SfM points and their colours in [0, 1]."""
    device = resolve_device(device)
    pts = np.asarray(points_xyz, np.float32)
    rgb = np.asarray(points_rgb, np.float32)
    if max_points is not None and pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                              replace=False)
        pts, rgb = pts[sel], rgb[sel]
    n = pts.shape[0]

    c = sh_lib.sh_coeff_count(max_sh_degree)
    sh = torch.zeros((n, 3, c), dtype=torch.float32, device=device)
    sh[:, :, 0] = sh_lib.rgb_to_sh_dc(torch.from_numpy(rgb).to(device))
    pts_t = torch.from_numpy(pts).to(device)
    mean_dist = mean_knn_distance(pts_t).cpu().numpy()
    scales = np.log(np.maximum(mean_dist, MIN_SCALE))[:, None].repeat(3, 1)
    quats = torch.zeros((n, 4), dtype=torch.float32, device=device)
    quats[:, 0] = 1.0
    op = inverse_sigmoid(torch.tensor(INIT_OPACITY, dtype=torch.float32))
    op = torch.full((n,), float(op), dtype=torch.float32, device=device)
    return GaussianState.create(means=pts_t, quats=quats, log_scales=scales,
                                opacity_logits=op, sh=sh, capacity=capacity,
                                device=device)

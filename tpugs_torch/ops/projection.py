"""Stage 1: project all gaussians to screen space, as in
tpugs/ops/projection.py.

Culling writes masks instead of early returns: `visible` is False for dead
slots, near-plane culls (z <= 0.2), degenerate 2D covariances (det <= 0)
and zero radii; radii is 0 for culled entries. The radius is capped at
max(W, H).
"""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.core import sh as sh_lib
from tpugs_torch.core import transforms as tf


@dataclasses.dataclass
class ProjectionOutput:
    """Per-gaussian screen-space quantities."""

    means2d: torch.Tensor  # [N, 2] pixel coords
    depths: torch.Tensor  # [N] camera-space z
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # [N] int32 pixel radius, 0 = culled
    rgb: torch.Tensor  # [N, 3] SH color, clamped >= 0
    opac: torch.Tensor  # [N] sigmoid opacity
    visible: torch.Tensor  # [N] bool


def project_gaussians(means, quats, log_scales, opacity_logits, sh, alive,
                      viewmat, intrinsics, img_w: int, img_h: int,
                      sh_degree: int, scale_modifier: float = 1.0
                      ) -> ProjectionOutput:
    """Project [N]-batched gaussians through a 4x4 world->camera matrix.
    intrinsics = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    W = viewmat[:3, :3]

    t_cam = tf.world_to_camera_points(means, viewmat)
    tz = t_cam[..., 2]
    in_front = tz > tf.NEAR_PLANE
    safe_z = torch.where(in_front, tz, torch.ones_like(tz))

    x_screen = fx * t_cam[..., 0] / safe_z + cx
    y_screen = fy * t_cam[..., 1] / safe_z + cy
    means2d = torch.stack([x_screen, y_screen], dim=-1)

    t_guard = torch.where(in_front[..., None], t_cam, torch.ones_like(t_cam))
    cov2d = tf.ewa_cov2d_scalar(log_scales, quats, W, t_guard, fx, fy,
                                scale_modifier)
    conic, det = tf.inv_cov2d(cov2d)

    radius = torch.clamp(tf.radius_from_cov2d(cov2d), max=max(img_w, img_h))

    visible = alive & in_front & (det > 0.0) & (radius > 0)
    radii = torch.where(visible, radius, torch.zeros_like(radius))

    opac = torch.where(alive, torch.sigmoid(opacity_logits),
                       torch.zeros_like(opacity_logits))

    # View direction from the camera center, held constant for gradients.
    cam_center = -viewmat[:3, :3].T @ viewmat[:3, 3]
    dirs = means - cam_center
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-12)
    dirs = dirs.detach()
    # maximum, not clamp: at an exact 0 it passes half the gradient, as the
    # reference's jnp.maximum does.
    rgb = sh_lib.eval_sh(sh_degree, sh, dirs)
    rgb = torch.maximum(rgb, torch.zeros_like(rgb))

    return ProjectionOutput(means2d=means2d, depths=tz, conic=conic,
                            radii=radii, rgb=rgb, opac=opac, visible=visible)

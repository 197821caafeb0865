"""Core 3DGS geometry, as in tpugs/core/transforms.py: quaternions,
covariances, the EWA projection.

Conventions: quaternions are (w, x, y, z), normalised before use; a 2x2
symmetric matrix is packed as (a, b, c) == [[a, b], [b, c]] in a trailing
dimension of size 3.
"""
from __future__ import annotations

import numpy as np
import torch

# Low-pass filter added to the projected 2D covariance (EWA anti-aliasing).
COV2D_LOWPASS = 0.3
# Near-plane cull distance.
NEAR_PLANE = 0.2


def _log_modifier(scale_modifier: float) -> float:
    """log(mod + 1e-8) taken in float32, as the reference takes it (so the
    default modifier 1.0 adds exactly 0)."""
    return float(np.log(np.float32(scale_modifier + 1e-8)))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def compute_cov3d(log_scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = M M^T with M = R diag(exp(log_s + log(mod))) -> [..., 3, 3]."""
    s = torch.exp(log_scales + _log_modifier(scale_modifier))
    R = quat_to_rotmat(quats)
    M = R * s[..., None, :]
    return M @ M.transpose(-1, -2)


def perspective_jacobian(t_cam: torch.Tensor, fx, fy) -> torch.Tensor:
    """Jacobian of the pinhole projection at t [..., 3] -> [..., 2, 3]."""
    tx, ty, tz = t_cam[..., 0], t_cam[..., 1], t_cam[..., 2]
    tz_inv = 1.0 / (tz + 1e-6)
    tz_inv2 = tz_inv * tz_inv
    zero = torch.zeros_like(tx)
    row0 = torch.stack([fx * tz_inv, zero, -fx * tx * tz_inv2], dim=-1)
    row1 = torch.stack([zero, fy * tz_inv, -fy * ty * tz_inv2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def compute_cov2d(cov3d: torch.Tensor, W: torch.Tensor, t_cam: torch.Tensor,
                  fx, fy) -> torch.Tensor:
    """EWA projection J W Sigma W^T J^T + 0.3 I -> packed (a, b, c) [..., 3]."""
    J = perspective_jacobian(t_cam, fx, fy)
    T = J @ W
    cov = T @ cov3d @ T.transpose(-1, -2)
    a = cov[..., 0, 0] + COV2D_LOWPASS
    b = cov[..., 0, 1]
    c = cov[..., 1, 1] + COV2D_LOWPASS
    return torch.stack([a, b, c], dim=-1)


def radius_from_cov2d(cov2d: torch.Tensor) -> torch.Tensor:
    """ceil(3 sqrt(lambda_max)) pixel radius, int32 [...]; 0 if degenerate."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    trace = a + c
    disc = torch.clamp(trace * trace - 4.0 * det, min=0.0)
    lam_max = 0.5 * (trace + torch.sqrt(disc))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    return torch.where(lam_max > 0.0, radius, torch.zeros_like(radius)).to(torch.int32)


def inv_cov2d(cov2d: torch.Tensor):
    """Inverse of packed symmetric 2x2 [..., 3] -> (conic [..., 3], det [...]);
    zero where det <= 0."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    ok = det > 0.0
    safe_det = torch.where(ok, det, torch.ones_like(det))
    inv_det = torch.where(ok, 1.0 / safe_det, torch.zeros_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    return conic, det


class _WorldToCamera(torch.autograd.Function):
    """p R^T + t, with the arithmetic of a BLAS's fused multiply-add
    chain, fma(z, R2, fma(y, R1, x R0)) + t, which the CPU's matmul computes
    for 15 rows and more, done elementwise: each fma as the exact float64
    product plus the float32 sum, rounded to float32. A BLAS picks its
    kernel, and its rounding, by the number of rows; this gives each point
    the same bits however many points come with it, on the CPU and the
    card. The viewer's cached frame (ops/render_cached.py) re-projects per
    pair what render() projects per gaussian, and the two agree bit for
    bit. The backward is the matmul's."""

    @staticmethod
    def forward(ctx, positions, viewmat):
        ctx.save_for_backward(positions, viewmat)
        R, t = viewmat[:3, :3], viewmat[:3, 3]
        acc = positions[..., 0:1] * R[:, 0]
        for k in (1, 2):
            acc = (positions[..., k:k + 1].double() * R[:, k].double()
                   + acc.double()).float()
        return acc + t

    @staticmethod
    def backward(ctx, g):
        positions, viewmat = ctx.saved_tensors
        d_pos = d_vm = None
        if ctx.needs_input_grad[0]:
            d_pos = g @ viewmat[:3, :3]
        if ctx.needs_input_grad[1]:
            g2, p2 = g.reshape(-1, 3), positions.reshape(-1, 3)
            d_vm = torch.zeros_like(viewmat)
            d_vm[:3, :3] = g2.T @ p2
            d_vm[:3, 3] = g2.sum(0)
        return d_pos, d_vm


def world_to_camera_points(positions: torch.Tensor, viewmat: torch.Tensor) -> torch.Tensor:
    """Transform world points [..., 3] by a 4x4 world->camera matrix
    (_WorldToCamera: the same bits for a point whatever the row count)."""
    return _WorldToCamera.apply(positions, viewmat)


def cov3d_components(log_scales, quats, scale_modifier: float = 1.0):
    """The 6 unique entries of Sigma = M M^T as [..., 6] =
    (c00, c01, c02, c11, c12, c22)."""
    s = torch.exp(log_scales + _log_modifier(scale_modifier))
    q = quats / torch.sqrt(torch.sum(quats * quats, -1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    m00 = (1.0 - 2.0 * (y * y + z * z)) * s0
    m01 = (2.0 * (x * y - w * z)) * s1
    m02 = (2.0 * (x * z + w * y)) * s2
    m10 = (2.0 * (x * y + w * z)) * s0
    m11 = (1.0 - 2.0 * (x * x + z * z)) * s1
    m12 = (2.0 * (y * z - w * x)) * s2
    m20 = (2.0 * (x * z - w * y)) * s0
    m21 = (2.0 * (y * z + w * x)) * s1
    m22 = (1.0 - 2.0 * (x * x + y * y)) * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22
    return torch.stack([c00, c01, c02, c11, c12, c22], dim=-1)


def ewa_cov2d_scalar(log_scales, quats, W, t_cam, fx, fy,
                     scale_modifier: float = 1.0):
    """Component-wise EWA chain (log_scales [N,3], quats [N,4], W [3,3],
    t_cam [N,3]) -> packed 2D covariance [N, 3]; the same math as
    compute_cov2d(compute_cov3d(...)) with no [N, 3, 3] intermediates."""
    comps = cov3d_components(log_scales, quats, scale_modifier)
    return ewa_cov2d_from_comps(comps, W, t_cam, fx, fy)


def ewa_cov2d_from_comps(comps, W, t_cam, fx, fy):
    """Camera-dependent half of the EWA chain: cov3d components [..., 6] +
    camera (W [3,3], t_cam [..., 3]) -> packed 2D covariance [..., 3]."""
    c00, c01, c02 = comps[..., 0], comps[..., 1], comps[..., 2]
    c11, c12, c22 = comps[..., 3], comps[..., 4], comps[..., 5]
    tx, ty, tz = t_cam[..., 0], t_cam[..., 1], t_cam[..., 2]
    tz_inv = 1.0 / (tz + 1e-6)
    j00 = fx * tz_inv
    j02 = -fx * tx * tz_inv * tz_inv
    j11 = fy * tz_inv
    j12 = -fy * ty * tz_inv * tz_inv
    t00 = j00 * W[0, 0] + j02 * W[2, 0]
    t01 = j00 * W[0, 1] + j02 * W[2, 1]
    t02 = j00 * W[0, 2] + j02 * W[2, 2]
    t10 = j11 * W[1, 0] + j12 * W[2, 0]
    t11 = j11 * W[1, 1] + j12 * W[2, 1]
    t12 = j11 * W[1, 2] + j12 * W[2, 2]
    u00 = c00 * t00 + c01 * t01 + c02 * t02
    u01 = c01 * t00 + c11 * t01 + c12 * t02
    u02 = c02 * t00 + c12 * t01 + c22 * t02
    u10 = c00 * t10 + c01 * t11 + c02 * t12
    u11 = c01 * t10 + c11 * t11 + c12 * t12
    u12 = c02 * t10 + c12 * t11 + c22 * t12
    a = t00 * u00 + t01 * u01 + t02 * u02 + COV2D_LOWPASS
    b = t10 * u00 + t11 * u01 + t12 * u02
    c = t10 * u10 + t11 * u11 + t12 * u12 + COV2D_LOWPASS
    return torch.stack([a, b, c], dim=-1)

"""Real spherical harmonics (degree 0-3) color evaluation, as in
tpugs/core/sh.py: the 3DGS basis convention and the +0.5 bias."""
from __future__ import annotations

import torch

MAX_SH_DEGREE = 3

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
         1.0925484305920792, 0.5462742152960396)
SH_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
         0.3731763325901154, 0.4570457994644658, 1.4453057213202769,
         0.5900435899266435)


def sh_coeff_count(degree: int) -> int:
    """Coefficients per channel for a given degree: (d+1)^2."""
    return (degree + 1) * (degree + 1)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH basis values Y_k(dir) for k < (degree+1)^2. dirs [..., 3] -> [..., C]."""
    assert 0 <= degree <= MAX_SH_DEGREE
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * x * y * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(cols, dim=-1)


def eval_sh(degree: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH color with the +0.5 bias, unclamped. sh_coeffs [..., 3, C],
    dirs [..., 3] -> rgb [..., 3]."""
    basis = sh_basis(dirs, degree)
    k = basis.shape[-1]
    return torch.einsum("...ck,...k->...c", sh_coeffs[..., :k], basis) + 0.5


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """DC coefficients whose degree-0 colour is rgb: (rgb - 0.5) / C0."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    """The colour that degree 0 evaluates to: dc * C0 + 0.5."""
    return dc * SH_C0 + 0.5

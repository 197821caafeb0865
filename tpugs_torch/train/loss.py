"""Training losses, as in tpugs/train/loss.py: (1 - l) L1 + l (1 - SSIM)
with l = 0.2.

SSIM is Wang et al. with an 11x11 Gaussian window (sigma 1.5), zero (SAME)
padding, per-channel blur, C1 = 1e-4, C2 = 9e-4, dynamic range 1. The
window is separable, so the blur of the five moment maps is two banded
matrix products, A_h @ X @ A_w^T, in full float32: on the card TF32 would
keep about three decimal digits, so `_blur_maps` refuses to run with it
enabled.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference over all pixels and channels. |d| is taken
    as where(d >= 0, d, -d), so that its gradient at d = 0 (a pixel that
    matches, such as background on background) is +1, as jnp.abs's is;
    torch.abs's is 0."""
    d = rendered - target
    return torch.mean(torch.where(d >= 0, d, -d))


@functools.lru_cache(maxsize=32)
def _blur_matrix_np(dim: int, window_size: int, sigma: float = 1.5):
    """Banded blur matrix [dim, dim]: A @ x is the 1D SAME-padded Gaussian
    convolution of x along that axis."""
    half = window_size // 2
    t = np.arange(window_size, dtype=np.float64) - half
    k1 = np.exp(-(t**2) / (2.0 * sigma * sigma))
    k1 /= k1.sum()
    a = np.zeros((dim, dim), dtype=np.float32)
    i = np.arange(dim)
    for off in range(-half, half + 1):
        j = i + off
        m = (j >= 0) & (j < dim)
        a[i[m], j[m]] = k1[off + half]
    return a


_BLUR_ON_DEVICE: dict = {}


def _blur_matrix(dim: int, window_size: int, device) -> torch.Tensor:
    """_blur_matrix_np on `device`, copied there once per (device, size,
    window) and cached: a train step copies nothing from the host."""
    key = (torch.device(device), dim, window_size)
    a = _BLUR_ON_DEVICE.get(key)
    if a is None:
        a = torch.from_numpy(_blur_matrix_np(dim, window_size)).to(device)
        _BLUR_ON_DEVICE[key] = a
    return a


def _blur_maps(maps: torch.Tensor, window_size: int) -> torch.Tensor:
    """[B, H, W] -> [B, H, W]: separable Gaussian blur as two matmuls."""
    if maps.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                         torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "SSIM blur needs full float32 matmuls: TF32 is enabled "
            "(torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision)")
    h, w = maps.shape[1], maps.shape[2]
    a_h = _blur_matrix(h, window_size, maps.device)
    a_w = _blur_matrix(w, window_size, maps.device)
    return torch.matmul(torch.matmul(a_h, maps), a_w.T)


def ssim(rendered: torch.Tensor, target: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map [H, W] (channel mean); inputs [H, W, 3] in [0, 1]."""
    x = rendered.permute(2, 0, 1)
    y = target.permute(2, 0, 1)
    moments = torch.cat([x, y, x * x, y * y, x * y], dim=0)  # [15, H, W]
    blurred = _blur_maps(moments, window_size)
    mu_x, mu_y = blurred[0:3], blurred[3:6]
    e_x2, e_y2, e_xy = blurred[6:9], blurred[9:12], blurred[12:15]

    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    # Variances clamped at 0 (float error on flat patches). maximum, not
    # clamp: at an exact 0 (a flat black patch) it passes half the gradient,
    # as the reference's jnp.maximum does.
    zero = torch.zeros((), dtype=blurred.dtype, device=blurred.device)
    sigma_x2 = torch.maximum(e_x2 - mu_x2, zero)
    sigma_y2 = torch.maximum(e_y2 - mu_y2, zero)
    sigma_xy = e_xy - mu_xy

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    )
    return torch.mean(ssim_map, dim=0)


def ssim_loss(rendered, target, window_size: int = 11):
    return 1.0 - torch.mean(ssim(rendered, target, window_size))


def combined_loss(rendered, target, lambda_ssim: float = 0.2):
    """(1 - l) L1 + l (1 - SSIM)."""
    return ((1.0 - lambda_ssim) * l1_loss(rendered, target)
            + lambda_ssim * ssim_loss(rendered, target))

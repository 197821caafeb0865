"""Synthetic gaussian scenes, drawn with the same numpy RNG calls as
tpugs/utils/synthetic.py so both packages see the same scene from a seed."""
from __future__ import annotations

import numpy as np
import torch


def synthetic_params_numpy(n: int, seed: int = 0, sh_coeffs: int = 16,
                           depth_range=(2.0, 10.0), xy_extent: float = 1.5,
                           scale_range=(0.01, 0.08)) -> dict[str, np.ndarray]:
    """Random cloud of gaussians in front of an identity camera (numpy)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [
            rng.uniform(-xy_extent, xy_extent, (n, 2)),
            rng.uniform(*depth_range, (n, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = np.log(rng.uniform(*scale_range, (n, 3))).astype(np.float32)
    opacity_logits = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    sh = (rng.normal(size=(n, 3, sh_coeffs)) * 0.3).astype(np.float32)
    sh[:, :, 0] += 0.8
    return {
        "means": means,
        "quats": quats,
        "log_scales": log_scales,
        "opacity_logits": opacity_logits,
        "sh": sh,
    }


def synthetic_params(n: int, seed: int = 0, device="cpu", **kw) -> dict[str, torch.Tensor]:
    """synthetic_params_numpy as float32 tensors on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_params_numpy(n, seed, **kw).items()}


def pad_behind_camera(params: dict[str, torch.Tensor], n_total: int,
                      seed: int = 1) -> dict[str, torch.Tensor]:
    """`params` followed by n_total - N gaussians drawn from a seeded
    generator on params' device, behind the identity camera (z in (-10,
    -2]) and otherwise drawn as synthetic_params_numpy's with scales in
    [0.002, 0.015]: an identity view sees only `params`, while every
    per-gaussian stage (projection, binning, the reduction, Adam) runs over
    n_total, as one view of a large capture does."""
    dev = params["means"].device
    m = n_total - params["means"].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=dev)

    sh = torch.randn((m,) + tuple(params["sh"].shape[1:]), generator=g,
                     device=dev) * 0.3
    sh[:, :, 0] += 0.8
    extra = {
        "means": torch.cat([u(m, 2) * 3.0 - 1.5, -2.0 - 8.0 * u(m, 1)], 1),
        "quats": torch.randn((m, 4), generator=g, device=dev),
        "log_scales": torch.log(0.002 + 0.013 * u(m, 3)),
        "opacity_logits": u(m) * 5.0 - 2.0,
        "sh": sh,
    }
    return {k: torch.cat([params[k], extra.pop(k)]) for k in params}


def synthetic_intrinsics_numpy(img_w: int, img_h: int, fov_deg: float = 60.0) -> np.ndarray:
    f = 0.5 * img_w / np.tan(np.radians(fov_deg) / 2)
    return np.asarray([f, f, img_w / 2.0, img_h / 2.0], np.float32)


def synthetic_intrinsics(img_w: int, img_h: int, fov_deg: float = 60.0,
                         device="cpu") -> torch.Tensor:
    """(fx, fy, cx, cy) float32 on `device`: synthetic_intrinsics_numpy."""
    return torch.from_numpy(
        synthetic_intrinsics_numpy(img_w, img_h, fov_deg)).to(device)

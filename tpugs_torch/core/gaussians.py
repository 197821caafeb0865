"""Gaussian model parameters on the port's side.

The model is the JAX package's five learnable arrays: means [N, 3], quats
[N, 4] (w, x, y, z, unnormalised), log_scales [N, 3], opacity_logits [N]
and sh [N, 3, C]. `params_from_numpy` carries them across as tensors, so
both packages render the same model.
"""
from __future__ import annotations

import numpy as np
import torch

PARAM_NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def params_from_numpy(params: dict[str, np.ndarray],
                      device: str | torch.device) -> dict[str, torch.Tensor]:
    """The parameter dict as float32 tensors on `device` (numpy in, as the
    JAX package's dict converts with np.asarray)."""
    out = {}
    for name in PARAM_NAMES:
        arr = np.ascontiguousarray(np.asarray(params[name], np.float32))
        out[name] = torch.from_numpy(arr).to(device)
    out["opacity_logits"] = out["opacity_logits"].reshape(-1)
    return out

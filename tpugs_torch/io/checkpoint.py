"""Full training checkpoints, as in tpugs/io/checkpoint.py: one .npz with
params/<name>, alive, adam_m/<name>, adam_v/<name>, adam_count,
adc_grad_accum, adc_grad_count, adc_max_radii and key, and a JSON sidecar
{"step", "format": "tpugs-ckpt-v1"}. `key` holds the port's RNG state as
uint32 [2]; every other field loads in either package.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpugs_torch.device import resolve_device

FORMAT = "tpugs-ckpt-v1"


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_train_checkpoint(path: str, state, step: int):
    """state: tpugs_torch.train.trainer.TrainState."""
    flat = {f"params/{k}": _np(v) for k, v in state.params.items()}
    flat["alive"] = _np(state.alive)
    flat.update({f"adam_m/{k}": _np(v) for k, v in state.adam.m.items()})
    flat.update({f"adam_v/{k}": _np(v) for k, v in state.adam.v.items()})
    flat["adam_count"] = _np(state.adam.count)
    flat["adc_grad_accum"] = _np(state.adc.grad_accum)
    flat["adc_grad_count"] = _np(state.adc.grad_count)
    flat["adc_max_radii"] = _np(state.adc.max_radii)
    flat["key"] = np.asarray(state.key, np.uint32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "format": FORMAT}, f)


def load_train_checkpoint(path: str, device="cuda"):
    """-> (TrainState with tensors on `device`, step); 'cuda' unless 'cpu'
    is asked for."""
    from tpugs_torch.core.gaussians import train_state_from_numpy

    device = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    state = train_state_from_numpy(flat, device)
    with open(path + ".json") as f:
        meta = json.load(f)
    return state, int(meta["step"])

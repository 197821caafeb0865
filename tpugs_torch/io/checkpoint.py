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

from tpugs_torch.device import resolve_device

FORMAT = "tpugs-ckpt-v1"


def save_train_checkpoint(path: str, state, step: int):
    """state: tpugs_torch.train.trainer.TrainState."""
    from tpugs_torch.core.gaussians import train_state_to_numpy

    flat = train_state_to_numpy(state)
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

"""Gaussian model parameters on the port's side, as in
tpugs/core/gaussians.py.

The model is five learnable arrays: means [N, 3], quats [N, 4] (w, x, y, z,
unnormalised), log_scales [N, 3], opacity_logits [N] and sh [N, 3, C].
`GaussianState` pads them to a fixed capacity with an `alive` mask: dead
slots are never rendered. `params_from_numpy` carries the arrays across as
tensors, so both packages render the same model, and
`train_state_from_numpy` the whole train state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpugs_torch.core.sh import MAX_SH_DEGREE, sh_coeff_count
from tpugs_torch.device import resolve_device

PARAM_NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) - torch.log1p(-x)


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


def train_state_from_numpy(flat: dict[str, np.ndarray], device="cuda"):
    """The port's TrainState from the reference's TrainState leaves as numpy,
    named as in a checkpoint: params/<name>, alive, adam_m/<name>,
    adam_v/<name>, adam_count, adc_grad_accum, adc_grad_count,
    adc_max_radii and key (the port's uint32 [2] (seed, steps taken)), on
    `device` ('cuda' unless 'cpu' is asked for)."""
    from tpugs_torch.optim.adam import AdamState
    from tpugs_torch.optim.densify_adc import ADCState
    from tpugs_torch.train.trainer import TrainState

    device = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # a copy

    def group(prefix):
        return {k[len(prefix):]: t(v) for k, v in flat.items()
                if k.startswith(prefix)}

    return TrainState(
        params=group("params/"),
        alive=t(flat["alive"]),
        adam=AdamState(m=group("adam_m/"), v=group("adam_v/"),
                       count=t(flat["adam_count"])),
        adc=ADCState(grad_accum=t(flat["adc_grad_accum"]),
                     grad_count=t(flat["adc_grad_count"]),
                     max_radii=t(flat["adc_max_radii"])),
        key=np.asarray(flat["key"], np.uint32),
    )


def train_state_to_numpy(state) -> dict[str, np.ndarray]:
    """The reverse of train_state_from_numpy: a TrainState's fields as
    numpy, named as in a checkpoint."""
    n = lambda t: (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t))
    flat = {f"params/{k}": n(v) for k, v in state.params.items()}
    flat["alive"] = n(state.alive)
    flat.update({f"adam_m/{k}": n(v) for k, v in state.adam.m.items()})
    flat.update({f"adam_v/{k}": n(v) for k, v in state.adam.v.items()})
    flat["adam_count"] = n(state.adam.count)
    flat["adc_grad_accum"] = n(state.adc.grad_accum)
    flat["adc_grad_count"] = n(state.adc.grad_count)
    flat["adc_max_radii"] = n(state.adc.max_radii)
    flat["key"] = np.asarray(state.key, np.uint32)
    return flat


@dataclasses.dataclass
class GaussianState:
    """Structure-of-arrays model padded to a capacity Nc: the five
    parameter arrays and alive [Nc] bool (False = free slot)."""

    means: torch.Tensor
    quats: torch.Tensor
    log_scales: torch.Tensor
    opacity_logits: torch.Tensor
    sh: torch.Tensor
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return int(round(self.sh.shape[-1] ** 0.5)) - 1

    def num_alive(self) -> torch.Tensor:
        """[] int32 count of the live slots (on the state's device)."""
        return torch.sum(self.alive.to(torch.int32)).to(torch.int32)

    def params(self) -> dict:
        """The five learnable arrays as a dict (the optimizer's groups)."""
        return {
            "means": self.means,
            "sh": self.sh,
            "opacity_logits": self.opacity_logits,
            "log_scales": self.log_scales,
            "quats": self.quats,
        }

    def replace_params(self, p: dict) -> "GaussianState":
        """A state with the five arrays of `p` and this state's alive."""
        return dataclasses.replace(self, **{k: p[k] for k in PARAM_NAMES})

    @staticmethod
    def create(means, quats, log_scales, opacity_logits, sh,
               capacity: int | None = None, device="cuda") -> "GaussianState":
        """From dense arrays (numpy or tensors) of N live gaussians, padded
        with zeros to `capacity`, on `device` ('cuda' unless 'cpu' is asked
        for)."""
        device = resolve_device(device)
        n = means.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} gaussians")

        def pad(x):
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=torch.float32,
                              device=device)
            out[:n] = x
            return out

        return GaussianState(
            means=pad(means),
            quats=pad(quats),
            log_scales=pad(log_scales),
            opacity_logits=pad(torch.as_tensor(opacity_logits).reshape(n)),
            sh=pad(sh),
            alive=torch.arange(cap, device=device) < n,
        )

    @staticmethod
    def empty(capacity: int, sh_degree: int = MAX_SH_DEGREE,
              device="cuda") -> "GaussianState":
        """`capacity` free slots (identity quaternions, zeros elsewhere) on
        `device` ('cuda' unless 'cpu' is asked for)."""
        device = resolve_device(device)
        c = sh_coeff_count(sh_degree)
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
        quats = z(capacity, 4)
        quats[:, 0] = 1.0
        return GaussianState(means=z(capacity, 3), quats=quats,
                             log_scales=z(capacity, 3),
                             opacity_logits=z(capacity),
                             sh=z(capacity, 3, c),
                             alive=torch.zeros(capacity, dtype=torch.bool,
                                               device=device))

    def compact_arrays(self) -> dict:
        """The live gaussians as dense numpy arrays (for PLY export)."""
        idx = np.nonzero(self.alive.cpu().numpy())[0]
        return {name: getattr(self, name).detach().cpu().numpy()[idx]
                for name in PARAM_NAMES}

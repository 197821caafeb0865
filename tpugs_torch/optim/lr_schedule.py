"""Learning-rate schedules, as in tpugs/optim/lr_schedule.py: the position
group decays log-linearly, the other four groups are constant."""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.device import device_constant


@dataclasses.dataclass(frozen=True)
class PositionLRConfig:
    """lr(t) = lr_init (lr_final / lr_init)^(t / max_steps), clamped at the
    ends."""

    lr_init: float = 1.6e-4
    lr_final: float = 1.6e-6
    max_steps: int = 30000


LR_SH = 2.5e-3
LR_OPACITY = 0.05
LR_SCALE = 5e-3
LR_ROTATION = 1e-3


def position_lr(step, config: PositionLRConfig = PositionLRConfig(),
                device="cpu") -> torch.Tensor:
    """The position group's LR at `step`, a float32 scalar tensor computed
    in float32 as the reference computes it. A step already on `device`
    (as a train step's is) is read there; the ratio's float32 constant is
    cached on the device, so nothing is copied from the host."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    t = torch.clamp(step / config.max_steps, 0.0, 1.0)
    log_ratio = torch.log(device_constant(config.lr_final / config.lr_init,
                                          device))
    return config.lr_init * torch.exp(t * log_ratio)


def active_sh_degree_for_step(step: int, max_degree: int) -> int:
    """Progressive SH: one more degree every 1000 steps."""
    return min(step // 1000, max_degree)

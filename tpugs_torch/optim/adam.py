"""Adam over the five gaussian parameter groups, as in tpugs/optim/adam.py:
betas (0.9, 0.999), eps 1e-15, per-group LRs with the position group on
its decay schedule, bias correction in float32.

Plain tensor arithmetic on dicts of tensors, out of place, in the
reference's order of operations.
"""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.device import device_constant
from tpugs_torch.optim import lr_schedule


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    position_lr: lr_schedule.PositionLRConfig = dataclasses.field(
        default_factory=lr_schedule.PositionLRConfig
    )
    lr_sh: float = lr_schedule.LR_SH
    lr_opacity: float = lr_schedule.LR_OPACITY
    lr_scale: float = lr_schedule.LR_SCALE
    lr_rotation: float = lr_schedule.LR_ROTATION


@dataclasses.dataclass
class AdamState:
    m: dict  # first moments, the params' keys and shapes
    v: dict  # second moments
    count: torch.Tensor  # [] int32: steps taken


def adam_init(params: dict) -> AdamState:
    first = next(iter(params.values()))
    return AdamState(
        m={k: torch.zeros_like(v) for k, v in params.items()},
        v={k: torch.zeros_like(v) for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def group_lrs(config: AdamConfig, step, device="cpu") -> dict:
    """Per-group learning rates at `step`."""
    return {
        "means": lr_schedule.position_lr(step, config.position_lr, device),
        "sh": config.lr_sh,
        "opacity_logits": config.lr_opacity,
        "log_scales": config.lr_scale,
        "quats": config.lr_rotation,
    }


def adam_step(config: AdamConfig, state: AdamState, params: dict,
              grads: dict, step):
    """One Adam update. `step` is the schedule step, `state.count` the
    bias-correction step. Returns (params, state)."""
    t = state.count + 1
    tf = t.to(torch.float32)
    # float32 betas, cached on the device: no copy from the host per step.
    bc1 = 1.0 - torch.pow(device_constant(config.beta1, tf.device), tf)
    bc2 = 1.0 - torch.pow(device_constant(config.beta2, tf.device), tf)
    lrs = group_lrs(config, step, tf.device)

    new_params, new_m, new_v = {}, {}, {}
    for k in params:
        g = grads[k]
        m = config.beta1 * state.m[k] + (1.0 - config.beta1) * g
        v = config.beta2 * state.v[k] + (1.0 - config.beta2) * g * g
        m_hat = m / bc1
        v_hat = v / bc2
        new_params[k] = params[k] - lrs[k] * m_hat / (torch.sqrt(v_hat)
                                                      + config.eps)
        new_m[k] = m
        new_v[k] = v
    return new_params, AdamState(m=new_m, v=new_v, count=t)


def zero_slots(state: AdamState, mask: torch.Tensor) -> AdamState:
    """The moments of the slots where mask [Nc] is True set to zero (the
    slots densification rewrote); the other slots keep theirs."""

    def zap(x):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        return torch.where(m, torch.zeros_like(x), x)

    return AdamState(m={k: zap(v) for k, v in state.m.items()},
                     v={k: zap(v) for k, v in state.v.items()},
                     count=state.count)

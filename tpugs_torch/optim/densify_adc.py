"""Adaptive density control: the configuration and the accumulator state,
as in tpugs/optim/densify_adc.py. The Trainer's state and checkpoint carry
the state in every mode; clone, split, prune and the opacity reset are not
yet ported (ROADMAP A8)."""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    densify_from: int = 500
    densify_until: int = 15000
    densify_every: int = 100
    opacity_reset_every: int = 3000
    grad_threshold: float = 2e-4
    opacity_threshold: float = 0.005
    percent_dense: float = 0.01
    max_screen_size: int = 20
    max_gaussians: int = 0  # 0 = capacity-limited only
    skip_final_reset: bool = True


@dataclasses.dataclass
class ADCState:
    grad_accum: torch.Tensor  # [Nc] sum of screen-gradient norms
    grad_count: torch.Tensor  # [Nc] visibility counts
    max_radii: torch.Tensor  # [Nc] largest screen radius seen


def adc_init(capacity: int, device="cuda") -> ADCState:
    device = resolve_device(device)
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return ADCState(grad_accum=z(), grad_count=z(), max_radii=z())

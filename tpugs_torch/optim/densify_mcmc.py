"""MCMC densification: only its configuration, so that a TrainConfig and
its JSON file carry the same sections as the reference's. Relocation, noise
and growth are not yet ported (ROADMAP A8)."""
from __future__ import annotations

import dataclasses

from tpugs_torch.optim.lr_schedule import PositionLRConfig


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """The fields of tpugs/optim/densify_mcmc.py::MCMCConfig."""

    relocate_from: int = 500
    relocate_until: int = 15000
    relocate_every: int = 100
    dead_opacity_threshold: float = 0.005
    relocate_cap: float = 0.05
    noise_lr: float = 5e5
    position_lr: PositionLRConfig = dataclasses.field(
        default_factory=PositionLRConfig
    )
    noise_gate_k: float = 100.0
    noise_gate_t: float = 0.995
    noise_max_sigma: float = 0.05
    noise_stop_after_relocation: bool = True
    noise_clamp_until: int = 0
    lambda_opacity: float = 0.01
    lambda_scale: float = 0.01
    grow_factor: float = 0.05
    exact_relocation: bool = True
    relocation_n_max: int = 51

"""MCMC densification (Kheradmand et al., NeurIPS 2024), as in
tpugs/optim/densify_mcmc.py: relocation at fixed capacity.

- relocate: dead gaussians (sigmoid(opacity) < 0.005) move onto sources
  drawn from the living ones with probability proportional to opacity, at
  most 5% of N per event; with exact_relocation a source and its copies
  share the binomial opacity and scale correction, so the image is kept;
- noise every step: pos += noise_lr * xyz_lr(t) * Sigma @ (gate * randn),
  gate = sigmoid(-100 (sigmoid(opacity) - 0.995)), clamped to 0.05 of the
  gaussian's largest axis (the clamp is load-bearing: without it the
  noise at SfM-init scales destroys the scene during warm-up);
- regularization 0.01 mean(sigmoid(opacity)) + 0.01 mean(exp(scales)),
  added to the loss;
- grow: up to 5% of N more gaussians into free slots per event, placed as
  relocation targets.

Every draw (the noise's normals, the sources' uniforms, the jitter of
exact_relocation=False) comes from a torch.Generator on the state's device
or is passed in pre-drawn. The `mode="drop"` scatters are writes into an
[Nc + 1] buffer (densify_adc.scatter_rows).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from tpugs_torch.core.transforms import compute_cov3d
from tpugs_torch.optim.densify_adc import scatter_rows
from tpugs_torch.optim.lr_schedule import PositionLRConfig, position_lr

RELOCATE_OPACITY = -4.59511985013459  # inverse_sigmoid(0.01)
RELOCATE_SCALE_SHRINK = 10.0
# log(10) as the reference's float32 constant.
LOG_RELOCATE_SCALE_SHRINK = float(
    np.log(np.float32(RELOCATE_SCALE_SHRINK)).astype(np.float32))
CDF_BLOCK = 1024  # sample_sources' block of the two-level CDF


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """The fields of tpugs/optim/densify_mcmc.py::MCMCConfig."""

    relocate_from: int = 500
    relocate_until: int = 15000
    relocate_every: int = 100
    dead_opacity_threshold: float = 0.005
    relocate_cap: float = 0.05
    noise_lr: float = 5e5
    # Must track the optimizer's position LR schedule (the Trainer sets it
    # from AdamConfig.position_lr).
    position_lr: PositionLRConfig = dataclasses.field(
        default_factory=PositionLRConfig
    )
    noise_gate_k: float = 100.0
    noise_gate_t: float = 0.995
    noise_max_sigma: float = 0.05
    noise_stop_after_relocation: bool = True
    noise_clamp_until: int = 0  # 0 = clamp forever
    lambda_opacity: float = 0.01
    lambda_scale: float = 0.01
    grow_factor: float = 0.05
    exact_relocation: bool = True
    relocation_n_max: int = 51

    def should_relocate(self, step: int) -> bool:
        return (self.relocate_from <= step <= self.relocate_until
                and step % self.relocate_every == 0)


def noise_scale(step, cfg: MCMCConfig = MCMCConfig(), device="cpu"):
    """noise_lr times the decaying position LR, a float32 scalar tensor."""
    return cfg.noise_lr * position_lr(step, cfg.position_lr, device)


def inject_noise(cfg: MCMCConfig, params: dict, alive: torch.Tensor, step,
                 generator: torch.Generator | None = None,
                 normal: torch.Tensor | None = None) -> dict:
    """pos += noise_scale(step) * Sigma @ (gate * normal) for the alive
    gaussians; normal [N, 3] standard normals, else drawn from
    `generator`."""
    means = params["means"]
    dev = means.device
    if normal is None:
        normal = torch.randn(means.shape, generator=generator, device=dev)
    s = torch.as_tensor(step, dtype=torch.float32).to(dev)
    lr = noise_scale(s, cfg, dev)
    opac = torch.sigmoid(params["opacity_logits"])
    gate = torch.sigmoid(-cfg.noise_gate_k * (opac - cfg.noise_gate_t))
    eps = gate[:, None] * normal
    cov3d = compute_cov3d(params["log_scales"], params["quats"])
    noise = lr * torch.einsum("nij,nj->ni", cov3d, eps)
    # Clamp at noise_max_sigma * sigma_max; released after noise_clamp_until.
    sigma_max = torch.exp(torch.amax(params["log_scales"], dim=-1))
    norm = torch.sqrt(torch.sum(noise * noise, dim=-1) + 1e-20)
    factor = torch.clamp(cfg.noise_max_sigma * sigma_max / norm, max=1.0)
    one = torch.ones_like(factor)
    if cfg.noise_clamp_until > 0:
        factor = torch.where(s < cfg.noise_clamp_until, factor, one)
    if cfg.noise_stop_after_relocation:
        factor = factor * torch.where(s <= cfg.relocate_until, 1.0, 0.0)
    noise = noise * factor[:, None]
    out = dict(params)
    out["means"] = means + torch.where(alive[:, None], noise,
                                       torch.zeros_like(noise))
    return out


def regularization(cfg: MCMCConfig, params: dict, alive: torch.Tensor):
    """The loss term: lambda_opacity mean opacity + lambda_scale mean
    scale over the alive gaussians."""
    n = torch.clamp(torch.sum(alive.to(torch.float32)), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=alive.device)
    opac = torch.where(alive, torch.sigmoid(params["opacity_logits"]), zero)
    scales = torch.where(alive[:, None], torch.exp(params["log_scales"]), zero)
    return (cfg.lambda_opacity * torch.sum(opac) / n
            + cfg.lambda_scale * torch.sum(scales) / (3.0 * n))


@functools.lru_cache(maxsize=4)
def _binom_table(n_max: int) -> np.ndarray:
    """Lower-triangular binomial coefficients B[j, k] = C(j, k)."""
    b = np.zeros((n_max, n_max), np.float32)
    for j in range(n_max):
        for k in range(j + 1):
            b[j, k] = math.comb(j, k)
    return b


@functools.lru_cache(maxsize=8)
def _binoms_on(n_max: int, device: torch.device) -> torch.Tensor:
    """_binom_table on `device`, copied once (a copy from the host waits for
    the device)."""
    return torch.from_numpy(_binom_table(n_max)).to(device)


def relocation_correction(opac, scales, ratio, n_max: int = 51):
    """Opacity and scale of each of n identical overlapping copies that
    render as the one gaussian did:

        o' = 1 - (1 - o)^(1/n)
        sigma' = sigma * o / sum_{i=1..n} sum_{k=0..i-1}
                              C(i-1,k) (-1)^k o'^(k+1) / sqrt(k+1)

    opac [N], scales [N, 3] linear, ratio [N] int copy counts >= 1 (rows
    with ratio 1 pass through unchanged). The [N, n_max] @ [n_max, n_max]
    product runs in full float32: it raises on the card with TF32 on."""
    dev = opac.device
    if opac.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                         torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "relocation_correction needs full float32 matmuls: TF32 is "
            "enabled")
    ratio = torch.clamp(ratio, 1, n_max)
    o = torch.clamp(opac, 1e-6, 1.0 - 1e-6)
    new_o = 1.0 - torch.pow(1.0 - o, 1.0 / ratio.to(torch.float32))

    k = torch.arange(n_max, dtype=torch.float32, device=dev)
    sign = torch.where(k.to(torch.int32) % 2 == 0, 1.0, -1.0)
    powers = torch.pow(new_o[:, None], k[None, :] + 1.0)
    term = powers * (sign / torch.sqrt(k + 1.0))[None, :]
    binoms = _binoms_on(n_max, dev)
    inner = term @ binoms.T  # inner[:, j] = sum_k C(j, k) term_k
    j_mask = torch.arange(n_max, device=dev)[None, :] < ratio[:, None]
    denom = torch.sum(torch.where(j_mask, inner, torch.zeros_like(inner)),
                      dim=1)
    factor = o / torch.clamp(denom, min=1e-12)
    # ratio == 1 is an exact no-op (denom equals o there analytically).
    one = ratio == 1
    new_o = torch.where(one, opac, torch.clamp(new_o, 0.005, 1.0 - 1e-5))
    new_scales = torch.where(one[:, None], scales, scales * factor[:, None])
    return new_o, new_scales


def _place_copies(cfg: MCMCConfig, params: dict, opac, living, targets, grant,
                  src, scene_extent: float, generator=None, jitter=None):
    """Write the sources' copies into the target slots (targets[j] == Nc:
    no copy). exact_relocation: exact copies, and sources and copies take
    relocation_correction's opacity and scale; sources count as changed.
    Otherwise the reference's placement: position jittered by 0.01 *
    extent (jitter [Nc, 3] standard normals, else drawn from `generator`),
    scale / 10, opacity 0.01."""
    nc = params["means"].shape[0]
    dev = params["means"].device
    out = dict(params)
    out["sh"] = scatter_rows(params["sh"], targets, params["sh"][src])
    out["quats"] = scatter_rows(params["quats"], targets, params["quats"][src])
    written = scatter_rows(torch.zeros((nc,), dtype=torch.bool, device=dev),
                           targets, torch.ones((nc,), dtype=torch.bool,
                                               device=dev))
    if cfg.exact_relocation:
        src_used = torch.where(grant, src, nc)
        extra = torch.zeros((nc + 1,), dtype=torch.int32, device=dev)
        extra.index_add_(0, src_used, torch.ones_like(src_used, dtype=torch.int32))
        extra = extra[:nc]
        ratio = 1 + extra
        new_op, new_sc = relocation_correction(
            opac, torch.exp(params["log_scales"]), ratio, cfg.relocation_n_max)
        new_logit = torch.log(new_op) - torch.log1p(-new_op)
        new_logsc = torch.log(torch.clamp(new_sc, min=1e-30))
        touched_src = living & (extra > 0)

        out["means"] = scatter_rows(params["means"], targets,
                                    params["means"][src])
        op_new = torch.where(touched_src, new_logit, params["opacity_logits"])
        out["opacity_logits"] = scatter_rows(op_new, targets, new_logit[src])
        sc_new = torch.where(touched_src[:, None], new_logsc,
                             params["log_scales"])
        out["log_scales"] = scatter_rows(sc_new, targets, new_logsc[src])
        changed = touched_src | written
    else:
        if jitter is None:
            jitter = torch.randn((nc, 3), generator=generator, device=dev)
        jitter = jitter * (0.01 * scene_extent)
        out["means"] = scatter_rows(params["means"], targets,
                                    params["means"][src] + jitter)
        out["log_scales"] = scatter_rows(
            params["log_scales"], targets,
            params["log_scales"][src] - LOG_RELOCATE_SCALE_SHRINK)
        out["opacity_logits"] = scatter_rows(
            params["opacity_logits"], targets,
            torch.full((nc,), RELOCATE_OPACITY, device=dev))
        changed = written
    return out, changed


def _opacity(params: dict) -> torch.Tensor:
    """sigmoid(opacity logit) taken in float64 and rounded to float32: the
    same value on every device (float32 sigmoids differ by an ulp between
    the CPU and the card), so the dead mask and the sources' weights are
    too."""
    return torch.sigmoid(params["opacity_logits"].double()).float()


def source_cdf(opac, living) -> torch.Tensor:
    """[Nc] float32 CDF of the living gaussians' opacities, two-level as the
    reference's: a cumsum inside blocks of 1024 plus the blocks' offsets.
    Both sums run in float64, where they are exact (float32 weights of
    living gaussians lie in [0.005, 1], so a total below 2^21 keeps every
    bit), so the CDF and the draws through it do not depend on the
    device's order of summation."""
    w = torch.where(living, opac, torch.zeros_like(opac)).to(torch.float64)
    nc = w.shape[0]
    nb = min(CDF_BLOCK, nc)
    npad = -(-nc // nb) * nb
    wpad = torch.cat([w, w.new_zeros(npad - nc)]).reshape(npad // nb, nb)
    within = torch.cumsum(wpad, dim=1)
    block_tot = within[:, -1]
    offs = torch.cumsum(block_tot, dim=0) - block_tot
    return (within + offs[:, None]).reshape(-1)[:nc].to(torch.float32)


def sample_sources(opac, living, k: int, generator=None, u=None):
    """k indices drawn with replacement, with probability proportional to
    opacity over the living gaussians, by inverse CDF (source_cdf): u [k]
    uniforms in [0, 1) (else drawn from `generator`) scaled by the total,
    then searchsorted(right=True). Dead sources have zero-width intervals
    and are never drawn."""
    c = source_cdf(opac, living)
    nc = c.shape[0]
    if u is None:
        u = torch.rand((k,), generator=generator, device=c.device)
    idx = torch.searchsorted(c, u * c[-1], right=True)
    return torch.clamp(idx, 0, nc - 1)


def relocate(cfg: MCMCConfig, params: dict, alive: torch.Tensor,
             scene_extent: float, generator=None, u=None, jitter=None):
    """One relocation event. u [Nc] (the sources' uniforms) and jitter
    [Nc, 3] are drawn from `generator` in that order where not given.
    Returns (params, changed [Nc], stats: num_relocated, num_dead,
    num_total). The alive mask does not change: dead gaussians are alive
    slots whose opacity collapsed."""
    nc = alive.shape[0]
    i32 = torch.int32
    opac = _opacity(params)
    dead = alive & (opac < cfg.dead_opacity_threshold)
    living = alive & ~dead

    n_total = torch.sum(alive.to(i32))
    n_dead = torch.sum(dead.to(i32))
    n_living = n_total - n_dead
    cap = (cfg.relocate_cap * n_total.to(torch.float32)).to(i32)
    n_relocate = torch.minimum(n_dead, cap)
    n_relocate = torch.where((n_dead == 0) | (n_living == 0),
                             torch.zeros_like(n_relocate), n_relocate)

    # Targets: the first n_relocate dead slots, in slot order.
    dead_order = torch.argsort(torch.where(dead, 0, 1), stable=True)
    grant = torch.arange(nc, device=alive.device) < n_relocate
    targets = torch.where(grant, dead_order, nc)
    src = sample_sources(opac, living, nc, generator, u)
    out, changed = _place_copies(cfg, params, opac, living, targets, grant,
                                 src, scene_extent, generator, jitter)
    stats = {"num_relocated": n_relocate, "num_dead": n_dead,
             "num_total": n_total}
    return out, changed, stats


def grow(cfg: MCMCConfig, params: dict, alive: torch.Tensor,
         scene_extent: float, max_gaussians: int = 0, generator=None, u=None,
         jitter=None):
    """Up to grow_factor * N new gaussians in free slots (at most
    max_gaussians alive when > 0), placed as relocation targets. Draws as
    relocate's. Returns (params, alive, changed, num_added)."""
    nc = alive.shape[0]
    i32 = torch.int32
    opac = _opacity(params)
    living = alive & (opac >= cfg.dead_opacity_threshold)
    n_alive = torch.sum(alive.to(i32))
    n_free = nc - n_alive
    cap = max_gaussians if max_gaussians > 0 else nc
    budget = torch.clamp(cap - n_alive, min=0)
    n_new = torch.minimum(
        (cfg.grow_factor * n_alive.to(torch.float32)).to(i32),
        torch.minimum(n_free, budget))
    n_new = torch.where(torch.sum(living.to(i32)) == 0,
                        torch.zeros_like(n_new), n_new)

    free_order = torch.argsort(torch.where(alive, 1, 0), stable=True)
    grant = torch.arange(nc, device=alive.device) < n_new
    targets = torch.where(grant, free_order, nc)
    src = sample_sources(opac, living, nc, generator, u)
    out, changed = _place_copies(cfg, params, opac, living, targets, grant,
                                 src, scene_extent, generator, jitter)
    written = scatter_rows(torch.zeros((nc,), dtype=torch.bool,
                                       device=alive.device),
                           targets, torch.ones((nc,), dtype=torch.bool,
                                               device=alive.device))
    return out, alive | written, changed | written, n_new

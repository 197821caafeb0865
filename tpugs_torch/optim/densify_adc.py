"""Adaptive density control (clone, split, prune), as in
tpugs/optim/densify_adc.py: shape-stable on capacity-padded arrays.

- accumulate ||dL/d(screen xy)|| (scaled to NDC units) and the largest
  screen radius of every visible gaussian;
- clone: avg_grad >= 2e-4 and max(exp(scale)) < percent_dense * extent;
- split: avg_grad >= 2e-4 and max(exp(scale)) >= percent_dense * extent,
  two children at scale - log(1.6), positions jittered by randn *
  exp(new scale);
- prune: sigmoid(opacity) < 0.005, and after the first opacity reset also
  a screen radius > 20 or a world size > 0.1 * extent;
- opacity reset to inverse_sigmoid(0.01).

Pruned and dead slots form the free list; clones take free slots in
descending-gradient order, a granted split writes child 1 over its parent
and child 2 into a free slot, and requests past the free slots do not fire.
Nothing is reallocated: the kernels see the same [Nc] shapes after an
event.

The reference's `arr.at[dst].set(rows, mode="drop")` scatters, with dst =
Nc for a row that must not land, become writes into an [Nc + 1] buffer
whose last row is discarded (`scatter_rows`): only dropped rows share an
index, so the order in which CUDA's index_put_ writes duplicates cannot
matter. The split noise comes from a torch.Generator on the state's
device, or pre-drawn as standard normals.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpugs_torch.device import resolve_device

RESET_OPACITY = -4.59511985013459  # log(0.01 / 0.99)
SPLIT_SCALE_FACTOR = 1.6
# log(1.6) as the reference's float32 constant: float32(log(float32(1.6))).
# torch's float32 log rounds it one ulp lower.
LOG_SPLIT_SCALE = float(
    np.log(np.float32(SPLIT_SCALE_FACTOR)).astype(np.float32))
WS_PRUNE_FRACTION = 0.1


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
    # Skip an opacity reset that leaves less than a full reset period of
    # densify events before densify_until (the reference's last reset at
    # densify_until leaves nothing to recover from it); False keeps it.
    skip_final_reset: bool = True

    def should_densify(self, step: int) -> bool:
        return (self.densify_from <= step <= self.densify_until
                and step % self.densify_every == 0)

    def should_reset_opacity(self, step: int) -> bool:
        last_ok = (self.densify_until - self.opacity_reset_every
                   if self.skip_final_reset else self.densify_until)
        return (self.opacity_reset_every > 0 and step > 0
                and step % self.opacity_reset_every == 0 and step <= last_ok)


@dataclasses.dataclass
class ADCState:
    grad_accum: torch.Tensor  # [Nc] sum of screen-gradient norms
    grad_count: torch.Tensor  # [Nc] visibility counts
    max_radii: torch.Tensor  # [Nc] largest screen radius seen


def adc_init(capacity: int, device="cuda") -> ADCState:
    device = resolve_device(device)
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return ADCState(grad_accum=z(), grad_count=z(), max_radii=z())


def adc_accumulate(state: ADCState, d_means2d: torch.Tensor,
                   radii: torch.Tensor, grad_scale=1.0) -> ADCState:
    """One step's accumulation. grad_scale = (W/2, H/2) takes the pixel
    gradient to the NDC units the 2e-4 threshold is calibrated for."""
    visible = radii > 0
    g = d_means2d * grad_scale
    norms = torch.sqrt(torch.sum(g * g, dim=-1))
    zero = torch.zeros((), dtype=norms.dtype, device=norms.device)
    return ADCState(
        grad_accum=state.grad_accum + torch.where(visible, norms, zero),
        grad_count=state.grad_count + visible.to(torch.float32),
        max_radii=torch.maximum(state.max_radii, radii.to(torch.float32)),
    )


def reset_opacity(params: dict) -> dict:
    """Every opacity logit set to inverse_sigmoid(0.01)."""
    out = dict(params)
    out["opacity_logits"] = torch.full_like(params["opacity_logits"],
                                            RESET_OPACITY)
    return out


def scatter_rows(arr: torch.Tensor, dst: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """arr with rows[j] written at dst[j]; dst[j] == len(arr) drops row j.
    The kept dsts must be distinct."""
    buf = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    buf[dst] = rows
    return buf[:-1]


def adc_densify(cfg: ADCConfig, params: dict, alive: torch.Tensor,
                adc: ADCState, scene_extent: float, size_pruning_active: bool,
                generator: torch.Generator | None = None,
                noise1: torch.Tensor | None = None,
                noise2: torch.Tensor | None = None):
    """One densification event. noise1, noise2: [Nc, 3] standard normals for
    the two split children, else drawn from `generator` (on the state's
    device) in that order. size_pruning_active: step > opacity_reset_every.

    Returns (params, alive, changed [Nc] (the slots whose Adam moments must
    be zeroed), a fresh ADCState, stats: num_cloned, num_split, num_pruned,
    num_after as 0-d tensors on the device)."""
    nc = alive.shape[0]
    dev = alive.device
    i32 = torch.int32
    avg_grad = adc.grad_accum / torch.clamp(adc.grad_count, min=1.0)
    max_scale = torch.amax(torch.exp(params["log_scales"]), dim=-1)
    size_thresh = cfg.percent_dense * scene_extent

    high_grad = alive & (avg_grad >= cfg.grad_threshold)
    clone_mask = high_grad & (max_scale < size_thresh)
    split_mask = high_grad & (max_scale >= size_thresh)

    opac = torch.sigmoid(params["opacity_logits"])
    keep = opac >= cfg.opacity_threshold
    if size_pruning_active:
        keep &= adc.max_radii <= float(cfg.max_screen_size)
        keep &= max_scale <= WS_PRUNE_FRACTION * scene_extent

    # Free slots this round: already dead, or pruned and not a split parent.
    dead_free = ~alive | (alive & ~keep & ~split_mask)
    free_count = torch.sum(dead_free.to(i32))
    if cfg.max_gaussians > 0:
        headroom = cfg.max_gaussians - torch.sum(alive.to(i32))
        free_count = torch.minimum(free_count, torch.clamp(headroom, min=0))
    ar = torch.arange(nc, device=dev)
    # Free slots first, each group in slot order.
    free_idx = torch.argsort(torch.where(dead_free, 0, 1), stable=True)
    inf = torch.full_like(avg_grad, float("inf"))

    # Clones, highest average gradient first.
    n_clone = torch.sum(clone_mask.to(i32))
    g_clones = torch.minimum(n_clone, free_count)
    clone_src = torch.argsort(torch.where(clone_mask, -avg_grad, inf),
                              stable=True)
    clone_dst = torch.where(ar < g_clones, free_idx, nc)

    # Splits: child 1 reuses the parent's slot, child 2 the next free slot.
    n_split = torch.sum(split_mask.to(i32))
    g_splits = torch.minimum(n_split, free_count - g_clones)
    grant_split_row = ar < g_splits
    split_src = torch.argsort(torch.where(split_mask, -avg_grad, inf),
                              stable=True)
    split_dst2 = torch.where(
        grant_split_row, free_idx[torch.clamp(g_clones + ar, 0, nc - 1)], nc)
    split_granted = scatter_rows(
        torch.zeros((nc,), dtype=torch.bool, device=dev),
        torch.where(grant_split_row, split_src, nc),
        torch.ones((nc,), dtype=torch.bool, device=dev))

    if noise1 is None:
        noise1 = torch.randn((nc, 3), generator=generator, device=dev)
    if noise2 is None:
        noise2 = torch.randn((nc, 3), generator=generator, device=dev)
    new_log_scales_parent = params["log_scales"] - LOG_SPLIT_SCALE
    sigma = torch.exp(new_log_scales_parent)
    noise1 = noise1 * sigma
    noise2 = noise2 * sigma

    new_params = {k: scatter_rows(v, clone_dst, v[clone_src])
                  for k, v in params.items()}
    # Split child 2 into free slots (jittered position, reduced scale).
    child2 = dict(params)
    child2["means"] = params["means"] + noise2
    child2["log_scales"] = new_log_scales_parent
    for k in new_params:
        new_params[k] = scatter_rows(new_params[k], split_dst2,
                                     child2[k][split_src])
    # Split child 1 over its granted parent.
    gm = split_granted[:, None]
    new_params["means"] = torch.where(gm, params["means"] + noise1,
                                      new_params["means"])
    new_params["log_scales"] = torch.where(gm, new_log_scales_parent,
                                           new_params["log_scales"])

    no = torch.zeros((nc,), dtype=torch.bool, device=dev)
    yes = torch.ones((nc,), dtype=torch.bool, device=dev)
    clone_written = scatter_rows(no, clone_dst, yes)
    child2_written = scatter_rows(no, split_dst2, yes)
    survivors = alive & keep & ~split_mask
    unsplit_parents = alive & split_mask & ~split_granted & keep
    new_alive = (survivors | unsplit_parents | split_granted | clone_written
                 | child2_written)
    changed = clone_written | child2_written | split_granted
    stats = {
        "num_cloned": g_clones,
        "num_split": g_splits,
        "num_pruned": torch.sum((alive & ~keep).to(i32)),
        "num_after": torch.sum(new_alive.to(i32)),
    }
    return new_params, new_alive, changed, adc_init(nc, dev), stats

"""Training loop, as in tpugs/train/trainer.py: on one device, or on each
rank of a ("data", "gauss") mesh (TrainConfig.mesh, parallel/).

Each step renders one view with gradients (the compositor's backward kernel
and the sorted segment reduction), takes the L1 + SSIM loss (plus MCMC's
regularization), and applies Adam; in ADC mode it also accumulates the
screen-space gradient of a zero probe, in MCMC mode it adds position noise.
make_train_step is the one step; make_train_multi_step runs a block of K
steps, as the reference runs `steps_per_call` steps inside one compiled
scan: on the card as replays of the step captured as a CUDA graph
(train/graph.py), with no host read and no copy from the host inside the
block; on the CPU eagerly, step by step. The Trainer trains through it
(under a mesh through parallel/dist_train.make_dist_multi_step, the same
block over the mesh step), and decides per block the views drawn (one
numpy draw per block) and the schedule of logs, events, checkpoints,
evaluations and overflow checks, reading the block's losses and
statistics once after it. The image bank stays on the device.

Densification events (ADC's opacity reset and densify, MCMC's relocate and
grow) run eagerly after each block for the steps it covered, as the
reference's do. Their random draws come from torch.Generators seeded from
the state's key (seed, steps taken) and a stream tag, so a resumed run
draws what an uninterrupted one does.

Under a mesh every rank runs this loop with the same schedule: it holds
its gauss shard of the state (the initial slots interleaved over the
shards, so each starts with about N0/G alive gaussians and as many free
slots) and its data row's views, and runs its blocks through
make_dist_multi_step (graphed or eager alike on every rank: the choice
rests on the device and the mesh's backend). All ranks draw the same (K, D)
local view indices per block; a rank takes its row's column. Checkpoints
and evaluation gather the shards (every rank takes part; rank 0 writes and
logs); a checkpoint is the whole state in its slot layout, so it loads on
one device or on a mesh of any G that divides its capacity.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from tpugs_torch import cuda_lib
from tpugs_torch.core.gaussians import GaussianState
from tpugs_torch.core.init import init_from_sfm
from tpugs_torch.data.dataset import Dataset
from tpugs_torch.device import device_constant, resolve_device
from tpugs_torch.io.ply import write_gaussian_ply
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_step, zero_slots)
from tpugs_torch.optim.densify_adc import (ADCConfig, ADCState,
                                           adc_accumulate, adc_densify,
                                           adc_init, reset_opacity)
from tpugs_torch.optim.densify_mcmc import (MCMCConfig, grow, inject_noise,
                                            regularization, relocate)
from tpugs_torch.optim.lr_schedule import active_sh_degree_for_step
from tpugs_torch.train import graph
from tpugs_torch.train.metrics import evaluate_views
from tpugs_torch.train.loss import combined_loss
from tpugs_torch.utils.memory import MemoryWatchdog, check_memory_budget


@dataclasses.dataclass
class TrainConfig:
    """The reference's knobs, field for field (so one JSON file configures
    either package)."""

    iterations: int = 30000
    resolution_scale: int = 1
    sh_degree: int = 3
    lambda_ssim: float = 0.2
    save_every: int = 7000
    log_every: int = 100
    eval_every: int = 0  # 0 = only at end
    capacity: int = 1 << 17  # fixed gaussian capacity
    random_background: bool = False
    seed: int = 42
    densify_mode: str = "adc"  # "adc" | "mcmc" | "none"
    adam: AdamConfig = dataclasses.field(default_factory=AdamConfig)
    adc: ADCConfig = dataclasses.field(default_factory=ADCConfig)
    mcmc: MCMCConfig = dataclasses.field(default_factory=MCMCConfig)
    tile_h: int = 32
    tile_w: int = 32
    pair_capacity: int = 1 << 21
    max_hits_per_tile: int = 2048
    output_dir: str = "output"
    # Steps per block: the views of a block are drawn at once and events
    # land on block boundaries (auto-clamped to divide the schedule).
    steps_per_call: int = 25
    auto_pair_capacity: bool = True
    pair_capacity_headroom: float = 8.0
    mesh: str = ""
    dist_send_capacity: int = -1
    hbm_watchdog: bool = True
    hbm_limit_mb: float = 0.0
    # On a pair or tile-hit overflow: "grow" the capacities and go on,
    # "warn" and keep truncating, or "error" (checkpoint and raise).
    on_overflow: str = "grow"


def train_config_from_dict(d: dict) -> TrainConfig:
    """A TrainConfig from a (possibly partial) dict; the nested "adam",
    "adc" and "mcmc" sections map to their dataclasses; unknown keys
    raise."""
    d = dict(d)
    kwargs = {}
    nested = {"adam": AdamConfig, "adc": ADCConfig, "mcmc": MCMCConfig}
    for name, cls in nested.items():
        if name in d:
            sub = d.pop(name)
            fields = {f.name for f in dataclasses.fields(cls)}
            unknown = sorted(set(sub) - fields)
            if unknown:
                raise ValueError(
                    f"config section {name!r}: unknown keys {unknown}")
            kwargs[name] = cls(**sub)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"config: unknown keys {unknown}")
    return TrainConfig(**d, **kwargs)


def load_train_config(path: str) -> TrainConfig:
    with open(path) as f:
        return train_config_from_dict(json.load(f))


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> tensor: the five parameter groups
    alive: torch.Tensor  # [Nc] bool
    adam: AdamState
    adc: ADCState
    key: np.ndarray  # uint32 [2]: (seed, steps taken), the port's RNG state


@dataclasses.dataclass
class StepStats:
    loss: torch.Tensor
    l1: torch.Tensor
    num_pairs: torch.Tensor
    pair_overflow: torch.Tensor
    max_tile_hits: torch.Tensor
    hit_overflow: torch.Tensor
    # Under a mesh (None on one device): the worst rank's pairs, and the
    # exchange's overflow and worst send count.
    max_local_pairs: torch.Tensor | None = None
    send_overflow: torch.Tensor | None = None
    max_send_count: torch.Tensor | None = None


def initial_key(seed: int) -> np.ndarray:
    return np.asarray([seed & 0xFFFFFFFF, 0], np.uint32)


def _background_host(key: np.ndarray, random: bool) -> torch.Tensor:
    """Black, or uniform in [0, 1)^3 drawn from the step's key, on the
    host."""
    if not random:
        return torch.zeros((3,))
    gen = torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))
    return torch.rand((3,), generator=gen)


def _background(key: np.ndarray, random: bool, device) -> torch.Tensor:
    """_background_host on `device` (black is made there)."""
    if not random:
        return torch.zeros((3,), device=device)
    return _background_host(key, random).to(device)


# Stream tags of the draws made from a state's key besides the background.
NOISE_STREAM, DENSIFY_STREAM, RELOCATE_STREAM = 1, 2, 3


def _generator_seed(key: np.ndarray, stream: int,
                    shard: int | None = None) -> int:
    entropy = [int(key[0]), int(key[1]), stream]
    if shard is not None:
        entropy.append(int(shard))
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def event_generator(key: np.ndarray, stream: int, device="cuda",
                    shard: int | None = None) -> torch.Generator:
    """A torch.Generator on `device` ('cuda' unless 'cpu' is asked for)
    seeded from the key (seed, steps taken) and a stream tag; under a mesh
    also the gauss shard's index, so shards draw apart and data rows
    alike."""
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(
        _generator_seed(key, stream, shard))


def _make_step_core(cfg: TrainConfig, raster: RasterConfig):
    """The step's computation on explicit inputs: (state, image, viewmat,
    intrinsics, step, sh_degree, background [3], noise generator) ->
    (params, AdamState, ADCState, StepStats), all new tensors. `step` is
    the schedule step, a float32 scalar tensor (on the device, or on the
    CPU, from where the LR schedule copies it)."""
    adc_mode = cfg.densify_mode == "adc"
    mcmc_mode = cfg.densify_mode == "mcmc"
    # NDC units: the 2e-4 threshold is calibrated for them, a (W/2, H/2)
    # factor above the pixel gradient.
    grad_scale = (raster.img_w * 0.5, raster.img_h * 0.5)

    def core(state: TrainState, image, viewmat, intrinsics, step,
             sh_degree: int, background, noise_gen):
        dev = image.device
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        probe = None
        if adc_mode:
            probe = torch.zeros((state.alive.shape[0], 2), device=dev,
                                requires_grad=True)
        out = render(params["means"], params["quats"], params["log_scales"],
                     params["opacity_logits"], params["sh"], state.alive,
                     viewmat, intrinsics, raster, sh_degree, background,
                     means2d_probe=probe)
        loss = combined_loss(out.color, image, cfg.lambda_ssim)
        if mcmc_mode:
            loss = loss + regularization(cfg.mcmc, params, state.alive)
        names = list(params)
        grads = torch.autograd.grad(
            loss, [params[k] for k in names] + ([probe] if adc_mode else []))
        with torch.no_grad():
            new_params, new_adam = adam_step(
                cfg.adam, state.adam, state.params,
                dict(zip(names, grads)), step)
            adc = state.adc
            if adc_mode:
                adc = adc_accumulate(adc, grads[-1], out.radii,
                                     device_constant(grad_scale, dev))
            if mcmc_mode:
                new_params = inject_noise(cfg.mcmc, new_params, state.alive,
                                          step, noise_gen)
            l1 = torch.mean(torch.abs(out.color - image))
        stats = StepStats(loss=loss.detach(), l1=l1, num_pairs=out.num_pairs,
                          pair_overflow=out.pair_overflow,
                          max_tile_hits=out.max_tile_hits,
                          hit_overflow=out.hit_overflow)
        return new_params, new_adam, adc, stats

    return core


def _step_of(cfg: TrainConfig, core, shard: int | None = None):
    """One train step from a step core: the background and MCMC's noise
    generator drawn from the state's key (under a mesh the noise also from
    the gauss shard's index), the key advanced once."""
    mcmc_mode = cfg.densify_mode == "mcmc"

    def train_step(state: TrainState, image, viewmat, intrinsics, step,
                   sh_degree: int):
        dev = image.device
        noise = (event_generator(state.key, NOISE_STREAM, dev, shard)
                 if mcmc_mode else None)
        params, adam, adc, stats = core(
            state, image, viewmat, intrinsics, step, sh_degree,
            _background(state.key, cfg.random_background, dev), noise)
        key = state.key + np.asarray([0, 1], np.uint32)
        return TrainState(params=params, alive=state.alive, adam=adam,
                          adc=adc, key=key), stats

    return train_step


def make_train_step(cfg: TrainConfig, raster: RasterConfig,
                    scene_extent: float):
    """One training step: render with gradients, L1 + SSIM (+ MCMC's
    regularization), Adam; ADC's gradient accumulation or MCMC's noise.
    Outside ADC mode the step builds no screen-space probe. `step` is the
    schedule step as a float32 scalar tensor; one on the device is read
    there, one on the CPU is copied over."""
    return _step_of(cfg, _make_step_core(cfg, raster))


# Staged per-step inputs of a graphed block: view index, schedule step,
# background r g b.
_ROW = 5


class _GraphedSteps:
    """A multi-step's card path: the step's state in static buffers, its
    per-step inputs staged rows (graph.BlockRunner). core: a step core
    (_make_step_core's contract; by default the single-device one for
    `raster`); shard: the gauss shard's index that MCMC's noise seed folds
    in under a mesh. The statistics kept are the fields the core fills."""

    def __init__(self, cfg: TrainConfig, raster: RasterConfig, device,
                 core=None, shard: int | None = None):
        self.cfg = cfg
        self.core = core if core is not None else _make_step_core(cfg, raster)
        self.shard = shard
        self.adc_mode = cfg.densify_mode == "adc"
        self.noise = (torch.Generator(device=device)
                      if cfg.densify_mode == "mcmc" else None)
        self.runner = graph.BlockRunner(
            device, _ROW, () if self.noise is None else (self.noise,))
        self.buf = None  # TrainState of the static buffers
        self.stats = None  # StepStats of static buffers
        self.stat_fields = None  # the StepStats fields the core fills
        self.bank = None  # the (images, viewmats, intrinsics) captured

    def _tensors(self, state: TrainState) -> list:
        names = sorted(state.params)
        out = ([state.params[k] for k in names]
               + [state.adam.m[k] for k in names]
               + [state.adam.v[k] for k in names]
               + [state.adam.count, state.alive])
        if self.adc_mode:
            out += [state.adc.grad_accum, state.adc.grad_count,
                    state.adc.max_radii]
        return out

    def _adopt(self, state: TrainState) -> None:
        """The state's values into the static buffers: a device copy of
        each tensor that is not already its buffer; new buffers (and new
        graphs) when a shape or type changed."""
        new = self._tensors(state)
        if self.buf is None or not graph.same_layout(new,
                                                     self._tensors(self.buf)):
            self.runner.release()
            c = lambda d: {k: torch.empty_like(v) for k, v in d.items()}  # noqa: E731
            adc = state.adc
            if self.adc_mode:
                adc = ADCState(*(torch.empty_like(getattr(adc, f)) for f in
                                 ("grad_accum", "grad_count", "max_radii")))
            self.buf = TrainState(
                params=c(state.params), alive=torch.empty_like(state.alive),
                adam=AdamState(m=c(state.adam.m), v=c(state.adam.v),
                               count=torch.empty_like(state.adam.count)),
                adc=adc, key=state.key)
        graph.load_buffers(self._tensors(self.buf), new)

    def _body(self, images, viewmats, intrinsics, sh_degree: int):
        runner, buf = self.runner, self.buf

        def body():
            row = runner.row()
            v = row[0].to(torch.int64).reshape(1)
            params, adam, adc, stats = self.core(
                buf, images.index_select(0, v)[0],
                viewmats.index_select(0, v)[0],
                intrinsics.index_select(0, v)[0], row[1], sh_degree,
                row[2:5], self.noise)
            new = TrainState(params=params, alive=buf.alive, adam=adam,
                             adc=adc, key=buf.key)
            with torch.no_grad():
                for b, t in zip(self._tensors(buf), self._tensors(new)):
                    if t is not b:
                        b.copy_(t)
                if self.stats is None:
                    self.stat_fields = [
                        f.name for f in dataclasses.fields(StepStats)
                        if getattr(stats, f.name) is not None]
                    self.stats = StepStats(**{
                        f: torch.empty_like(getattr(stats, f))
                        for f in self.stat_fields})
                for f in self.stat_fields:
                    getattr(self.stats, f).copy_(getattr(stats, f))
                runner.put_loss(stats.loss)
                runner.advance()

        return body

    def __call__(self, state: TrainState, images, viewmats, intrinsics,
                 vi: np.ndarray, step0: float, sh_degree: int):
        k = vi.shape[0]
        key0 = state.key
        self._adopt(state)
        bank = (images, viewmats, intrinsics)
        if self.bank is None or any(a is not b for a, b in
                                    zip(bank, self.bank)):
            self.runner.release()
            self.bank = bank
        rows = np.zeros((k, _ROW), np.float32)
        rows[:, 0] = vi
        rows[:, 1] = step0 + np.arange(k)
        keys = [key0 + np.asarray([0, j], np.uint32) for j in range(k)]
        if self.cfg.random_background:
            rows[:, 2:] = np.stack([_background_host(key, True).numpy()
                                    for key in keys])
        self.runner.stage(rows)
        before = None
        if self.noise is not None:
            seeds = [_generator_seed(key, NOISE_STREAM, self.shard)
                     for key in keys]

            def before(j):
                self.noise.manual_seed(seeds[j])
        # A degree below this one does not come again in a run.
        self.runner.release(keep=lambda deg: deg >= sh_degree)
        self.runner.run(sh_degree, k, self._body(images, viewmats,
                                                 intrinsics, sh_degree),
                        before)
        buf = self.buf
        out = TrainState(
            params=dict(buf.params), alive=buf.alive,
            adam=AdamState(m=dict(buf.adam.m), v=dict(buf.adam.v),
                           count=buf.adam.count),
            adc=buf.adc if self.adc_mode else state.adc,
            key=key0 + np.asarray([0, k], np.uint32))
        stats = StepStats(**{f: getattr(self.stats, f).clone()
                             for f in self.stat_fields})
        return out, self.runner.losses[:k].clone(), stats


def make_train_multi_step(cfg: TrainConfig, raster: RasterConfig,
                          scene_extent: float):
    """K train steps per call, as the reference's make_train_multi_step
    (K steps inside one jitted lax.scan: one dispatch per K steps):

        multi_step(state, image_bank [V, H, W, 3], viewmats [V, 4, 4],
                   intrinsics [V, 4], view_idx [K], step0, sh_degree)
          -> (state, losses [K], last StepStats)

    view_idx: the block's view indices, host ints (numpy, a list or a CPU
    tensor); step0: the schedule step of its first step, a number. Step j
    trains view view_idx[j] at schedule step step0 + j with the key
    advanced j times: K calls of make_train_step, exactly.

    On the card the block runs as replays of the step captured as a CUDA
    graph (train/graph.py): one staged copy of the block's inputs before
    it, no host read and no copy from the host inside it. The step is
    captured once per SH degree (a lower degree's graph is released then)
    and again when the image bank or the state's shapes change; the raster
    configuration is this multi-step's own, so grown capacities take a new
    one, as the reference re-jits. The first two steps before a capture
    run eagerly, as steps of the block. The returned state's tensors are
    the static buffers the graph updates in place, so the next call
    overwrites them (the reference donates its state likewise); a state
    whose tensors are others (after an event or a checkpoint load) is
    copied into them first. The losses and stats are copies. MCMC's noise
    comes from a generator registered with the graph and re-seeded before
    each step with event_generator's seed, so it draws what the eager step
    draws. On the CPU the steps run eagerly, one by one."""
    return _multi_step_of(cfg, raster, _make_step_core(cfg, raster))


def _multi_step_of(cfg: TrainConfig, raster: RasterConfig, core,
                   shard: int | None = None,
                   graphed_on=lambda dev: dev.type == "cuda"):
    """make_train_multi_step's block over a step core (_step_of's step K
    times): through _GraphedSteps where graphed_on(the bank's device)
    holds, else eagerly, step by step."""
    train_step = _step_of(cfg, core, shard)
    graphed = {}  # device -> _GraphedSteps

    def multi_step(state: TrainState, images, viewmats, intrinsics, view_idx,
                   step0, sh_degree: int):
        if isinstance(view_idx, torch.Tensor):
            if view_idx.is_cuda:
                raise ValueError("multi_step: view_idx must be host ints "
                                 "(reading a card tensor waits for it)")
            view_idx = view_idx.numpy()
        vi = np.asarray(view_idx, np.int64).reshape(-1)
        step0 = float(step0)
        dev = images.device
        if graphed_on(dev):
            if dev not in graphed:
                graphed[dev] = _GraphedSteps(cfg, raster, dev, core, shard)
            return graphed[dev](state, images, viewmats, intrinsics, vi,
                                step0, sh_degree)
        losses = []
        for j, v in enumerate(vi):
            state, stats = train_step(
                state, images[v], viewmats[v], intrinsics[v],
                torch.tensor(step0 + j, dtype=torch.float32), sh_degree)
            losses.append(stats.loss)
        return state, torch.stack(losses), stats

    multi_step.graphed = graphed  # device -> its graphs and counts
    return multi_step


def make_densify_step(cfg: TrainConfig, scene_extent: float):
    """An ADC event: clone, split, prune, and zero the moments of the
    slots it rewrote."""

    def densify(state: TrainState, size_pruning_active: bool):
        gen = event_generator(state.key, DENSIFY_STREAM, state.alive.device)
        with torch.no_grad():
            params, alive, changed, adc, stats = adc_densify(
                cfg.adc, state.params, state.alive, state.adc, scene_extent,
                size_pruning_active, generator=gen)
            adam = zero_slots(state.adam, changed)
        return TrainState(params=params, alive=alive, adam=adam, adc=adc,
                          key=state.key), stats

    return densify


def make_relocate_step(cfg: TrainConfig, scene_extent: float):
    """An MCMC event: relocate the dead, grow into free slots (grow_factor
    > 0), and zero the moments of the slots either changed."""

    def reloc(state: TrainState):
        gen = event_generator(state.key, RELOCATE_STREAM, state.alive.device)
        with torch.no_grad():
            params, changed, stats = relocate(
                cfg.mcmc, state.params, state.alive, scene_extent, gen)
            alive = state.alive
            if cfg.mcmc.grow_factor > 0:
                params, alive, grown, n_new = grow(
                    cfg.mcmc, params, alive, scene_extent, generator=gen)
                changed = changed | grown
                stats = dict(stats, num_added=n_new)
            adam = zero_slots(state.adam, changed)
        return TrainState(params=params, alive=alive, adam=adam,
                          adc=state.adc, key=state.key), stats

    return reloc


def reset_opacity_step(state: TrainState) -> TrainState:
    """Every opacity to 0.01, and only the opacity moments zeroed."""
    m, v = dict(state.adam.m), dict(state.adam.v)
    m["opacity_logits"] = torch.zeros_like(m["opacity_logits"])
    v["opacity_logits"] = torch.zeros_like(v["opacity_logits"])
    return TrainState(params=reset_opacity(state.params), alive=state.alive,
                      adam=AdamState(m=m, v=v, count=state.adam.count),
                      adc=state.adc, key=state.key)


def _block_length(step: int, k_max: int, iters: int) -> int:
    """The steps of the block from `step`: aligned to K, never crossing an
    SH-degree boundary or the run's end."""
    k_blk = k_max - (step % k_max) if step % k_max else k_max
    return min(k_blk, iters - step, 1000 - step % 1000)


def _read_block(losses: torch.Tensor, stats: StepStats):
    """A block's losses [K] and last StepStats read to the host in one
    copy -> (losses, float64 numpy [K]; StepStats of numpy scalars, so
    int() and bool() on them read nothing more)."""
    names = [f.name for f in dataclasses.fields(StepStats)
             if getattr(stats, f.name) is not None]
    vals = [getattr(stats, n) for n in names]
    host = torch.cat([losses.reshape(-1).to(torch.float64)] + [
        v.reshape(1).to(torch.float64) for v in vals]).cpu().numpy()
    k = losses.numel()
    kind = lambda v: (np.bool_ if v.dtype == torch.bool else  # noqa: E731
                      np.float64 if v.is_floating_point() else np.int64)
    return host[:k], StepStats(**{n: kind(v)(x) for n, v, x in
                                  zip(names, vals, host[k:])})


def _host_ints(stats: dict) -> dict:
    """An event's stats read back in one copy."""
    vals = torch.stack([v.to(torch.int64) for v in stats.values()]).tolist()
    return dict(zip(stats, vals))


def eval_views(dataset: Dataset, device="cuda") -> list:
    """The dataset's test views as (name, target image [H, W, 3] numpy,
    (viewmat, intrinsics) on `device`)."""
    device = resolve_device(device)
    views = []
    for i, cam in enumerate(dataset.test_cameras):
        views.append((cam.image_name, dataset.load_test_image(i), (
            torch.as_tensor(cam.world_to_camera(), dtype=torch.float32,
                            device=device),
            torch.as_tensor(cam.intrinsics_array(), device=device))))
    return views


def interleave_slots(x: torch.Tensor, g: int) -> torch.Tensor:
    """Slot i -> shard i % g, local slot i // g (a transpose), so each of
    the g contiguous shards gets every g-th slot."""
    n = x.shape[0]
    return x.reshape((n // g, g) + tuple(x.shape[1:])).transpose(0, 1) \
        .reshape(x.shape).contiguous()


class Trainer:
    """Dataset, state, the train step, the event schedule, logs and
    checkpoints, on one device ('cuda' unless 'cpu' is asked for) or, with
    config.mesh, on this rank of the mesh (its card: cuda:LOCAL_RANK)."""

    def __init__(self, data_dir: str, config: TrainConfig = TrainConfig(),
                 log_fn=print, resume_from: str | None = None,
                 device="cuda"):
        if config.densify_mode not in ("adc", "mcmc", "none"):
            raise ValueError(f"unknown densify_mode {config.densify_mode!r}")
        self.mesh = None
        if config.mesh:
            from tpugs_torch.parallel.dist_train import parse_mesh_spec

            self.mesh = parse_mesh_spec(config.mesh, device=device)
            device = self.mesh.device
        # Rank 0 writes and logs; the other ranks run the same program.
        self._primary = self.mesh is None or self.mesh.primary
        if not self._primary:
            log_fn = lambda *a, **k: None  # noqa: E731
        # MCMC's noise must follow the optimizer's position LR schedule.
        if config.mcmc.position_lr != config.adam.position_lr:
            log_fn(
                "WARNING: MCMCConfig.position_lr differs from "
                "AdamConfig.position_lr; overriding the MCMC noise schedule "
                "with the optimizer's (noise must track the actual xyz LR). "
                "Customize AdamConfig.position_lr to change both."
            )
            config = dataclasses.replace(config, mcmc=dataclasses.replace(
                config.mcmc, position_lr=config.adam.position_lr))
        self.device = resolve_device(device)
        self.cfg = config
        self.log = log_fn
        self.start_step = 0
        self.dataset = Dataset(data_dir, config.resolution_scale)
        if self.dataset.num_train() == 0:
            raise ValueError("no training cameras")
        self.scene_extent = self.dataset.scene_bounds.extent
        cam0 = self.dataset.train_cameras[0]
        if self.mesh is not None:
            self.log(f"mesh: data={self.mesh.data} gauss={self.mesh.gauss} "
                     f"({self.mesh.size} ranks, backend "
                     f"{self.mesh.backend or 'none'}, {self.device})")

        n_points = self.dataset.points_xyz.shape[0]
        capacity = max(config.capacity,
                       1 << int(np.ceil(np.log2(max(n_points, 1)))))
        g = self.mesh.gauss if self.mesh is not None else 1
        capacity = -(-capacity // g) * g  # divisible by the gauss axis
        gs = init_from_sfm(self.dataset.points_xyz, self.dataset.points_rgb,
                           capacity=capacity, max_sh_degree=config.sh_degree,
                           device=self.device)
        if g > 1:
            # Interleave the initial slots over the shards: init packs the
            # N0 alive gaussians into slots [0, N0), so contiguous shards
            # would leave shard 0 without free slots (no clone or split:
            # ADC's free lists are shard-local) and the last shards empty.
            gs = GaussianState(**{f: interleave_slots(getattr(gs, f), g)
                                  for f in ("means", "quats", "log_scales",
                                            "opacity_logits", "sh", "alive")})

        pair_capacity = config.pair_capacity
        if config.auto_pair_capacity:
            pair_capacity = self._auto_pair_capacity(gs, cam0, config)
        self.raster = RasterConfig(
            img_h=cam0.height, img_w=cam0.width,
            tile_h=config.tile_h, tile_w=config.tile_w,
            pair_capacity=pair_capacity,
            max_hits_per_tile=config.max_hits_per_tile,
        )
        est = check_memory_budget(
            capacity, (config.sh_degree + 1) ** 2, pair_capacity,
            cam0.height, cam0.width, self.dataset.num_train(),
            device=self.device,
        )
        self.log(f"memory budget: {est}")
        self.watchdog = None
        if config.hbm_watchdog:
            self.watchdog = MemoryWatchdog(limit_mb=config.hbm_limit_mb,
                                           log=self.log, device=self.device)

        params = gs.params()
        self.state = TrainState(params=params, alive=gs.alive,
                                adam=adam_init(params),
                                adc=adc_init(capacity, self.device),
                                key=initial_key(config.seed))
        if resume_from is not None:
            from tpugs_torch.io.checkpoint import load_train_checkpoint

            self.state, self.start_step = load_train_checkpoint(
                resume_from, self.device)
            self.log(f"resumed from {resume_from} at step {self.start_step}")
        if self.mesh is None:
            self._densify = make_densify_step(self.cfg, self.scene_extent)
            self._relocate = make_relocate_step(self.cfg, self.scene_extent)
            self._reset_opacity = reset_opacity_step
        else:
            from tpugs_torch.parallel import dist_train as DT

            self.state = DT.shard_train_state(self.mesh, self.state)
            self._densify = DT.make_dist_densify_step(self.cfg, self.mesh,
                                                      self.scene_extent)
            self._relocate = DT.make_dist_relocate_step(self.cfg, self.mesh,
                                                        self.scene_extent)
            self._reset_opacity = DT.make_dist_reset_opacity_step(self.mesh)
            if self.cfg.dist_send_capacity < 0:
                self._auto_send_capacity()
        self._build_train_step()
        self._eval_raster = None  # the evaluation's, grown on its own

        sizes = {(c.height, c.width) for c in self.dataset.train_cameras}
        if len(sizes) != 1:
            raise ValueError(f"mixed camera resolutions unsupported: {sizes}")
        self._images = None  # loaded at the first train()
        cams = self.dataset.train_cameras
        # The views this rank trains on: all of them, or under a mesh its
        # data row's block of views_per_row (wrapping around), drawn by a
        # local index.
        self._view_ids = np.arange(len(cams))
        self._num_views = len(cams)  # the range of a drawn view index
        self._draw_shape = ()
        if self.mesh is not None:
            d = self.mesh.data
            vpr = -(-len(cams) // d)
            i = self.mesh.data_index
            self._view_ids = np.arange(i * vpr, (i + 1) * vpr) % len(cams)
            self._num_views, self._draw_shape = vpr, (d,)
        self._viewmats = torch.as_tensor(
            np.stack([cams[i].world_to_camera() for i in self._view_ids]),
            dtype=torch.float32, device=self.device)
        self._intrinsics = torch.as_tensor(
            np.stack([cams[i].intrinsics_array() for i in self._view_ids]),
            device=self.device)
        self._rng = np.random.default_rng(config.seed)
        # A resumed run draws the views an uninterrupted one would draw from
        # here: replay the draws of the blocks before start_step.
        step, k_max = 0, self._effective_steps_per_call()
        while step < self.start_step:
            k_blk = _block_length(step, k_max, self.start_step)
            self._draw_views(k_blk)
            step += k_blk

    def _draw_views(self, k_blk: int) -> np.ndarray:
        """The block's view indices into this rank's views: one per step,
        or under a mesh one per (step, data row), this rank's column."""
        vi = self._rng.integers(0, self._num_views,
                                size=(k_blk,) + self._draw_shape)
        return vi if self.mesh is None else vi[:, self.mesh.data_index]

    def _build_train_step(self):
        """The multi-step for the current raster config and exchange
        capacity (again after they grow): a new one captures anew."""
        if self.mesh is None:
            self._multi_step = make_train_multi_step(self.cfg, self.raster,
                                                     self.scene_extent)
        else:
            from tpugs_torch.parallel.dist_train import make_dist_multi_step

            self._multi_step = make_dist_multi_step(
                self.cfg, self.raster, self.mesh, self.scene_extent)

    def _auto_send_capacity(self):
        """The exchange's slots per (source, destination): 1.3x the worst
        send count over up to 4 sample views, in multiples of 128, at most
        N/G; a later send overflow grows it (_handle_overflow)."""
        from tpugs_torch.parallel.dist_train import (auto_send_capacity,
                                                     measure_max_send_count)

        cams = self.dataset.train_cameras
        sample = cams[:: max(1, len(cams) // 4)][:4]
        worst = measure_max_send_count(
            self.mesh, self.raster, self.state.params, self.state.alive,
            [np.asarray(c.world_to_camera(), np.float32) for c in sample],
            [np.asarray(c.intrinsics_array()) for c in sample])
        n_loc = self.state.alive.shape[0]
        cap = auto_send_capacity(worst, n_loc)
        self.cfg = dataclasses.replace(self.cfg, dist_send_capacity=cap)
        self.log(
            f"auto exchange capacity: max initial send count {worst} -> "
            f"{cap} slots/(src,dst) (x1.3 headroom; safe bound {n_loc})")

    def _effective_send_capacity(self) -> int:
        """The exchange slots the mesh step uses (0 on one device)."""
        if self.mesh is None:
            return 0
        if self.cfg.dist_send_capacity > 0:
            return self.cfg.dist_send_capacity
        return self.state.alive.shape[0]

    def _any_rank(self, flag: bool) -> bool:
        """flag on any rank of the mesh (every rank then takes the same
        branch, as the collectives after it need)."""
        if self.mesh is None:
            return flag
        from tpugs_torch.parallel import comm
        from tpugs_torch.parallel.mesh import BOTH

        return bool(comm.all_reduce(torch.tensor(flag, device=self.device),
                                    self.mesh, BOTH, "max"))

    def _n_alive(self) -> int:
        n = torch.sum(self.state.alive.to(torch.int64))
        if self.mesh is not None:
            from tpugs_torch.parallel import comm

            n = comm.all_reduce(n, self.mesh, "gauss")
        return int(n)

    def _handle_overflow(self, stats: StepStats, step: int):
        """Pairs or tile hits past the capacities were dropped in the last
        step: warn, raise (after a checkpoint) or grow the capacities."""
        cfg = self.cfg
        msg = (
            f"[{step}] OVERFLOW: pairs {int(stats.num_pairs)}"
            f"/{self.raster.pair_capacity}, busiest tile "
            f"{int(stats.max_tile_hits)}/{self.raster.max_hits_per_tile}"
        )
        if self.mesh is not None:
            msg += (f", worst device pairs {int(stats.max_local_pairs)}, "
                    f"exchange sends {int(stats.max_send_count)}"
                    f"/{self._effective_send_capacity()}")
        msg += " (work dropped this block)"
        if cfg.on_overflow == "warn":
            self.log(msg)
            return
        if cfg.on_overflow == "error":
            self.log(msg)
            self.save_checkpoint(step)
            raise RuntimeError(msg + " — on_overflow='error', checkpoint saved")
        new_pairs = self.raster.pair_capacity
        new_hits = self.raster.max_hits_per_tile
        new_send = cfg.dist_send_capacity
        if bool(stats.pair_overflow):
            if self.mesh is None:
                target = int(1.3 * int(stats.num_pairs))
            else:
                # The overflow is against a rank's own list,
                # ceil(pair_capacity / G) x headroom: size the global
                # capacity so that it covers the worst slice.
                from tpugs_torch.parallel.tile_shard import (
                    PAIR_IMBALANCE_HEADROOM)

                target_local = 1.3 * int(stats.max_local_pairs)
                target = int(np.ceil(target_local * self.mesh.gauss
                                     / PAIR_IMBALANCE_HEADROOM))
            new_pairs = max(new_pairs, -(-target // 512) * 512)
        if bool(stats.hit_overflow):
            target = int(1.2 * int(stats.max_tile_hits))
            new_hits = max(new_hits, -(-target // 128) * 128)
        if (stats.send_overflow is not None and bool(stats.send_overflow)
                and cfg.dist_send_capacity > 0):
            # A tuned exchange capacity dropped records: grow it.
            target = int(1.3 * int(stats.max_send_count))
            new_send = max(new_send, -(-target // 128) * 128)
        if (new_pairs, new_hits, new_send) == (
                self.raster.pair_capacity, self.raster.max_hits_per_tile,
                cfg.dist_send_capacity):
            self.log(msg + " — capacities unchanged, no growth computed")
            return
        self.log(
            msg + f" -> growing pair_capacity "
            f"{self.raster.pair_capacity}->{new_pairs}, max_hits "
            f"{self.raster.max_hits_per_tile}->{new_hits}"
            + (f", send_capacity {cfg.dist_send_capacity}->{new_send}"
               if new_send != cfg.dist_send_capacity else "")
        )
        self.raster = dataclasses.replace(
            self.raster, pair_capacity=new_pairs, max_hits_per_tile=new_hits)
        if new_send != cfg.dist_send_capacity:
            self.cfg = dataclasses.replace(cfg, dist_send_capacity=new_send)
        self._build_train_step()

    def _image_bank(self) -> torch.Tensor:
        """This rank's views' images on its device (each rank loads only
        its data row's)."""
        if self._images is None:
            imgs = np.stack([self.dataset.load_train_image(int(i))
                             for i in self._view_ids])
            self._images = torch.from_numpy(imgs).to(self.device)
        return self._images

    def train(self, iterations: int | None = None):
        cfg = self.cfg
        iters = iterations if iterations is not None else cfg.iterations
        images = self._image_bank()
        os.makedirs(cfg.output_dir, exist_ok=True)

        t0 = time.perf_counter()
        window_start = t0
        history = []
        hist_path = os.path.join(cfg.output_dir, "history.jsonl")
        hist_f = (open(hist_path, "a" if self.start_step > 0 else "w")
                  if self._primary else open(os.devnull, "w"))
        k_max = self._effective_steps_per_call()

        step = self.start_step
        while step < iters:
            k_blk = _block_length(step, k_max, iters)
            vi = self._draw_views(k_blk)
            sh_deg = active_sh_degree_for_step(step, cfg.sh_degree)
            self.state, losses, stats = self._multi_step(
                self.state, images, self._viewmats, self._intrinsics, vi,
                step, sh_deg)
            # The block's one host read; it waits for its last kernel, so a
            # contract violation found on the card raises before any log or
            # save.
            losses, stats = _read_block(losses, stats)
            cuda_lib.check_guards()
            prev, step = step, step + k_blk

            overflow = (bool(stats.pair_overflow) or bool(stats.hit_overflow)
                        or bool(stats.send_overflow is not None
                                and stats.send_overflow))
            if overflow:
                self._handle_overflow(stats, step)

            # The events of every step the block covered: with K dividing
            # every period, at most one of each kind per block.
            for s in range(prev, step):
                if cfg.densify_mode == "adc":
                    if cfg.adc.should_reset_opacity(s):
                        self.state = self._reset_opacity(self.state)
                        self.log(f"[{s}] opacity reset")
                    if cfg.adc.should_densify(s):
                        self.state, dstats = self._densify(
                            self.state,
                            size_pruning_active=s > cfg.adc.opacity_reset_every)
                        d = _host_ints(dstats)
                        self.log(
                            f"[{s}] densify: +{d['num_cloned']} cloned, "
                            f"+{d['num_split']} split, "
                            f"-{d['num_pruned']} pruned, N={d['num_after']}")
                elif cfg.densify_mode == "mcmc" and cfg.mcmc.should_relocate(s):
                    self.state, rstats = self._relocate(self.state)
                    r = _host_ints(rstats)
                    added = r.get("num_added", 0)
                    self.log(
                        f"[{s}] mcmc relocate: {r['num_relocated']} of "
                        f"{r['num_dead']} dead, +{added} grown "
                        f"(N={r['num_total'] + added})")

                if cfg.log_every > 0 and s % cfg.log_every == 0:
                    loss = float(losses[s - prev])
                    now = time.perf_counter()
                    its = (cfg.log_every / max(now - window_start, 1e-9)
                           if s else 0.0)
                    window_start = now
                    n_alive = self._n_alive()
                    self.log(
                        f"[{s}] loss={loss:.4f} l1={float(stats.l1):.4f} "
                        f"N={n_alive} sh={sh_deg} pairs={int(stats.num_pairs)} "
                        f"{'OVERFLOW ' if bool(stats.pair_overflow) else ''}"
                        f"{its:.2f} it/s"
                    )
                    rec = {"step": s, "loss": loss, "l1": float(stats.l1),
                           "n": n_alive}
                    history.append(rec)
                    hist_f.write(json.dumps(rec) + "\n")
                    hist_f.flush()

                if (self.watchdog is not None and cfg.log_every > 0
                        and s % cfg.log_every == 0):
                    self.watchdog.check()
                    if self._any_rank(self.watchdog.should_abort()):
                        self.log(
                            f"[{s}] HBM over limit "
                            f"{self.watchdog.max_critical_streak} consecutive "
                            f"checks — checkpointing and aborting gracefully"
                        )
                        self.save_checkpoint(s)
                        hist_f.close()
                        return history

                if cfg.save_every > 0 and s > 0 and s % cfg.save_every == 0:
                    self.save_checkpoint(s)
                if cfg.eval_every > 0 and s > 0 and s % cfg.eval_every == 0:
                    # At the current warm-up degree, not the final one.
                    res = self.evaluate(
                        active_sh_degree_for_step(s, cfg.sh_degree))
                    self.log(
                        f"[{s}] eval: PSNR {res.mean_psnr:.2f} dB  "
                        f"SSIM {res.mean_ssim:.4f} ({len(res.images)} views)")

        hist_f.close()
        self.save_checkpoint(iters)
        total = time.perf_counter() - t0
        done = iters - self.start_step
        self.log(f"trained {done} iters in {total:.1f}s "
                 f"({done / max(total, 1e-9):.2f} it/s)")
        return history

    def _auto_pair_capacity(self, gs: GaussianState, cam0, config) -> int:
        """The pair capacity from the initial scene's pair count over a few
        views (rects from the 3-sigma radius), times the headroom for
        growth, rounded up to a power of two."""
        from tpugs_torch.ops.binning import tile_rects
        from tpugs_torch.ops.projection import project_gaussians

        def count_pairs(cam):
            with torch.no_grad():
                proj = project_gaussians(
                    gs.means, gs.quats, gs.log_scales, gs.opacity_logits,
                    gs.sh, gs.alive,
                    torch.as_tensor(cam.world_to_camera(), dtype=torch.float32,
                                    device=self.device),
                    torch.as_tensor(cam.intrinsics_array(), device=self.device),
                    cam0.width, cam0.height, 0)
                _, _, w, h = tile_rects(proj, cam0.width, cam0.height,
                                        config.tile_w, config.tile_h)
                return int(torch.sum((w * h).to(torch.int64)))

        cams = self.dataset.train_cameras
        sample = cams[:: max(1, len(cams) // 4)][:4]
        worst = max(count_pairs(c) for c in sample)
        target = int(max(worst, 1) * config.pair_capacity_headroom)
        cap = 1 << int(np.ceil(np.log2(max(target, 1 << 14))))
        cap = min(cap, config.pair_capacity)
        self.log(
            f"auto pair capacity: max initial pairs {worst} -> capacity {cap} "
            f"(x{config.pair_capacity_headroom:.0f} headroom)"
        )
        return cap

    def _effective_steps_per_call(self) -> int:
        """Largest K <= cfg.steps_per_call dividing every schedule period
        (the SH degree's 1000, log, save, eval, ADC's or MCMC's), so events
        land on block boundaries."""
        cfg = self.cfg
        periods = [1000]
        for p in (cfg.log_every, cfg.save_every, cfg.eval_every):
            if p > 0:
                periods.append(p)
        if cfg.densify_mode == "adc":
            periods += [cfg.adc.densify_every, max(cfg.adc.densify_from, 1)]
            if cfg.adc.opacity_reset_every > 0:
                periods.append(cfg.adc.opacity_reset_every)
        elif cfg.densify_mode == "mcmc":
            periods += [cfg.mcmc.relocate_every, max(cfg.mcmc.relocate_from, 1)]
        g = 0
        for p in periods:
            g = math.gcd(g, p)
        k = max(1, min(cfg.steps_per_call, g))
        while g % k:
            k -= 1
        return max(k, 1)

    def _eval_raster_config(self) -> RasterConfig:
        """The evaluation's raster config: it starts at training's and grows
        on its own (growing it does not touch the train step), but always
        covers training's capacities."""
        er = self._eval_raster
        if er is None:
            er = self.raster
        else:
            er = dataclasses.replace(
                er,
                pair_capacity=max(er.pair_capacity, self.raster.pair_capacity),
                max_hits_per_tile=max(er.max_hits_per_tile,
                                      self.raster.max_hits_per_tile))
        self._eval_raster = er
        return er

    def _handle_eval_overflow(self, name, num_pairs, pair_of, tile_hits,
                              hit_of) -> bool:
        """A test view's pairs or tile hits overflowed: raise ("error"),
        grow the eval capacities ("grow"; returns True and the caller
        renders again) or log ("warn"), never a silently truncated PSNR."""
        er = self._eval_raster
        msg = (
            f"eval view {name} OVERFLOW: pairs {num_pairs}"
            f"/{er.pair_capacity}, busiest tile {tile_hits}"
            f"/{er.max_hits_per_tile} (back-most pairs dropped)"
        )
        if self.cfg.on_overflow == "error":
            raise RuntimeError(msg)
        new_pairs, new_hits = er.pair_capacity, er.max_hits_per_tile
        if self.cfg.on_overflow == "grow":
            if pair_of:
                new_pairs = max(new_pairs,
                                -(-int(1.3 * num_pairs) // 512) * 512)
            if hit_of:
                new_hits = max(new_hits, -(-int(1.2 * tile_hits) // 128) * 128)
        if (new_pairs, new_hits) == (er.pair_capacity, er.max_hits_per_tile):
            self.log(msg + " — capacities unchanged (policy "
                     f"{self.cfg.on_overflow!r})")
            return False
        self.log(msg + f" -> growing eval pair_capacity {er.pair_capacity}->"
                 f"{new_pairs}, max_hits {er.max_hits_per_tile}->{new_hits}"
                 " (eval only)")
        self._eval_raster = dataclasses.replace(
            er, pair_capacity=new_pairs, max_hits_per_tile=new_hits)
        return True

    def evaluate(self, sh_degree: int | None = None):
        """PSNR/SSIM over the dataset's test views with the current model,
        rendered without gradients. A view whose pairs or tile hits
        overflow grows the eval capacities and renders again (or warns, or
        raises, by on_overflow)."""
        deg = self.cfg.sh_degree if sh_degree is None else sh_degree
        p, alive = self._whole_params()
        bg = torch.zeros((3,), device=self.device)

        def render_checked(name, args):
            for _ in range(8):  # growth converges: capacities only increase
                with torch.no_grad():
                    out = render(p["means"], p["quats"], p["log_scales"],
                                 p["opacity_logits"], p["sh"], alive, *args,
                                 self._eval_raster_config(), deg, bg,
                                 need_grads=False)
                num_pairs, pair_of, tile_hits, hit_of = torch.stack([
                    out.num_pairs.to(torch.int64),
                    out.pair_overflow.to(torch.int64),
                    out.max_tile_hits.to(torch.int64),
                    out.hit_overflow.to(torch.int64)]).tolist()
                if not (pair_of or hit_of):
                    break
                if not self._handle_eval_overflow(name, num_pairs,
                                                  bool(pair_of), tile_hits,
                                                  bool(hit_of)):
                    break
            return out.color

        res = evaluate_views(None, eval_views(self.dataset, self.device),
                             num_gaussians=int(torch.sum(alive)),
                             render_named=render_checked)
        # The views' kernels have run: a contract violation found on the
        # card raises before the metrics are returned.
        cuda_lib.check_guards()
        return res

    def _whole_params(self):
        """(params, alive) of the whole model on this rank's device: under a
        mesh the shards gathered over the gauss group, on the device (a
        collective: every rank calls this together)."""
        if self.mesh is None:
            return self.state.params, self.state.alive
        from tpugs_torch.parallel.dist_train import gathered_params

        return gathered_params(self.mesh, self.state.params, self.state.alive)

    def gaussian_state(self) -> GaussianState:
        """The whole model (under a mesh: gathered, a collective)."""
        p, alive = self._whole_params()
        return GaussianState(alive=alive, **p)

    def save_checkpoint(self, step: int, full: bool = True) -> str:
        """The live gaussians as a PLY and, with `full`, the whole train
        state as ckpt_<step>.npz (resumable). Under a mesh the shards are
        gathered on the device of every rank and rank 0 writes: its one
        copy to the host."""
        path = os.path.join(self.cfg.output_dir, f"model_{step:07d}.ply")
        state = self.state
        if self.mesh is not None:
            from tpugs_torch.parallel.dist_train import gathered_train_state

            state = gathered_train_state(self.mesh, state)
        if not self._primary:
            return path
        arrays = GaussianState(alive=state.alive,
                               **state.params).compact_arrays()
        write_gaussian_ply(
            path, arrays["means"], arrays["sh"], arrays["opacity_logits"],
            arrays["log_scales"], arrays["quats"])
        if full:
            from tpugs_torch.io.checkpoint import save_train_checkpoint

            save_train_checkpoint(
                os.path.join(self.cfg.output_dir, f"ckpt_{step:07d}.npz"),
                state, step)
        self.log(f"[{step}] checkpoint -> {path}")
        return path

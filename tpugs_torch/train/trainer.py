"""Training loop on one device, as in tpugs/train/trainer.py with
densify_mode="none".

Each step renders one view with gradients (the compositor's backward kernel
and the sorted segment reduction), takes the L1 + SSIM loss, and applies
Adam, as one eager PyTorch function. The reference runs `steps_per_call`
steps inside one compiled scan; the port keeps that block structure for
what it decides, the views drawn (one numpy draw per block) and the
schedule of logs, checkpoints and overflow checks, and runs the block's
steps one by one. The image bank stays on the device.

Not yet ported (each raises, naming its ROADMAP item): ADC and MCMC
densification (A8), the device mesh (A12) and evaluate (A8,
train/metrics.py).
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
from tpugs_torch.device import resolve_device
from tpugs_torch.io.ply import write_gaussian_ply_numpy
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_step
from tpugs_torch.optim.densify_adc import ADCConfig, ADCState, adc_init
from tpugs_torch.optim.densify_mcmc import MCMCConfig
from tpugs_torch.optim.lr_schedule import active_sh_degree_for_step
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


def initial_key(seed: int) -> np.ndarray:
    return np.asarray([seed & 0xFFFFFFFF, 0], np.uint32)


def _background(key: np.ndarray, random: bool, device) -> torch.Tensor:
    """Black, or uniform in [0, 1)^3 drawn from the step's key."""
    if not random:
        return torch.zeros((3,), device=device)
    gen = torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))
    return torch.rand((3,), generator=gen).to(device)


def make_train_step(cfg: TrainConfig, raster: RasterConfig):
    """One training step: render with gradients, L1 + SSIM, Adam."""

    def train_step(state: TrainState, image, viewmat, intrinsics, step,
                   sh_degree: int):
        background = _background(state.key, cfg.random_background,
                                 image.device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        out = render(params["means"], params["quats"], params["log_scales"],
                     params["opacity_logits"], params["sh"], state.alive,
                     viewmat, intrinsics, raster, sh_degree, background)
        loss = combined_loss(out.color, image, cfg.lambda_ssim)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        with torch.no_grad():
            new_params, new_adam = adam_step(
                cfg.adam, state.adam, state.params, grads, step)
            l1 = torch.mean(torch.abs(out.color - image))
        stats = StepStats(loss=loss.detach(), l1=l1, num_pairs=out.num_pairs,
                          pair_overflow=out.pair_overflow,
                          max_tile_hits=out.max_tile_hits,
                          hit_overflow=out.hit_overflow)
        key = state.key + np.asarray([0, 1], np.uint32)
        return TrainState(params=new_params, alive=state.alive, adam=new_adam,
                          adc=state.adc, key=key), stats

    return train_step


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: not yet ported to tpugs_torch (ROADMAP {item}); train with "
        f"densify_mode='none' (--no-densify) on one device")


class Trainer:
    """Dataset, state, the train step, the event schedule, logs and
    checkpoints, on one device ('cuda' unless 'cpu' is asked for)."""

    def __init__(self, data_dir: str, config: TrainConfig = TrainConfig(),
                 log_fn=print, resume_from: str | None = None,
                 device="cuda"):
        if config.densify_mode in ("adc", "mcmc"):
            raise _not_ported(f"densify_mode={config.densify_mode!r}", "A8")
        if config.densify_mode != "none":
            raise ValueError(f"unknown densify_mode {config.densify_mode!r}")
        if config.mesh:
            raise _not_ported(f"mesh={config.mesh!r}", "A12")
        if config.eval_every > 0:
            # Refused before any step: the evaluation it would reach is not
            # ported, and a run that raised there would lose its steps.
            raise NotImplementedError(
                f"eval_every={config.eval_every}: Trainer.evaluate "
                f"(train/metrics.py) is not yet ported to tpugs_torch "
                f"(ROADMAP A8c); train with eval_every=0")
        self.device = resolve_device(device)
        self.cfg = config
        self.log = log_fn
        self.start_step = 0
        self.dataset = Dataset(data_dir, config.resolution_scale)
        if self.dataset.num_train() == 0:
            raise ValueError("no training cameras")
        self.scene_extent = self.dataset.scene_bounds.extent
        cam0 = self.dataset.train_cameras[0]

        n_points = self.dataset.points_xyz.shape[0]
        capacity = max(config.capacity,
                       1 << int(np.ceil(np.log2(max(n_points, 1)))))
        gs = init_from_sfm(self.dataset.points_xyz, self.dataset.points_rgb,
                           capacity=capacity, max_sh_degree=config.sh_degree,
                           device=self.device)

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
        self._train_step = make_train_step(self.cfg, self.raster)

        sizes = {(c.height, c.width) for c in self.dataset.train_cameras}
        if len(sizes) != 1:
            raise ValueError(f"mixed camera resolutions unsupported: {sizes}")
        self._images = None  # loaded at the first train()
        cams = self.dataset.train_cameras
        self._viewmats = torch.as_tensor(
            np.stack([c.world_to_camera() for c in cams]), dtype=torch.float32,
            device=self.device)
        self._intrinsics = torch.as_tensor(
            np.stack([c.intrinsics_array() for c in cams]), device=self.device)
        self._rng = np.random.default_rng(config.seed)

    def _handle_overflow(self, stats: StepStats, step: int):
        """Pairs or tile hits past the capacities were dropped in the last
        step: warn, raise (after a checkpoint) or grow the capacities."""
        cfg = self.cfg
        msg = (
            f"[{step}] OVERFLOW: pairs {int(stats.num_pairs)}"
            f"/{self.raster.pair_capacity}, busiest tile "
            f"{int(stats.max_tile_hits)}/{self.raster.max_hits_per_tile}"
            " (work dropped this block)"
        )
        if cfg.on_overflow == "warn":
            self.log(msg)
            return
        if cfg.on_overflow == "error":
            self.log(msg)
            self.save_checkpoint(step)
            raise RuntimeError(msg + " — on_overflow='error', checkpoint saved")
        new_pairs = self.raster.pair_capacity
        new_hits = self.raster.max_hits_per_tile
        if bool(stats.pair_overflow):
            target = int(1.3 * int(stats.num_pairs))
            new_pairs = max(new_pairs, -(-target // 512) * 512)
        if bool(stats.hit_overflow):
            target = int(1.2 * int(stats.max_tile_hits))
            new_hits = max(new_hits, -(-target // 128) * 128)
        if (new_pairs, new_hits) == (self.raster.pair_capacity,
                                     self.raster.max_hits_per_tile):
            self.log(msg + " — capacities unchanged, no growth computed")
            return
        self.log(
            msg + f" -> growing pair_capacity "
            f"{self.raster.pair_capacity}->{new_pairs}, max_hits "
            f"{self.raster.max_hits_per_tile}->{new_hits}"
        )
        self.raster = dataclasses.replace(
            self.raster, pair_capacity=new_pairs, max_hits_per_tile=new_hits)
        self._train_step = make_train_step(self.cfg, self.raster)

    def _image_bank(self) -> torch.Tensor:
        if self._images is None:
            imgs = np.stack([self.dataset.load_train_image(i)
                             for i in range(self.dataset.num_train())])
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
        hist_f = open(hist_path, "a" if self.start_step > 0 else "w")
        k_max = self._effective_steps_per_call()

        step = self.start_step
        while step < iters:
            # Block length: aligned to K, never crossing an SH-degree boundary.
            k_blk = k_max - (step % k_max) if step % k_max else k_max
            k_blk = min(k_blk, iters - step, 1000 - step % 1000)
            vi = self._rng.integers(0, self.dataset.num_train(), size=k_blk)
            sh_deg = active_sh_degree_for_step(step, cfg.sh_degree)
            losses = []
            for j, v in enumerate(vi):
                self.state, stats = self._train_step(
                    self.state, images[v], self._viewmats[v],
                    self._intrinsics[v],
                    torch.tensor(step + j, dtype=torch.float32), sh_deg)
                losses.append(stats.loss)
            prev, step = step, step + k_blk

            overflow = bool(stats.pair_overflow) or bool(stats.hit_overflow)
            # The read above waited for the block's last kernel: a contract
            # violation found on the card raises before any log or save.
            cuda_lib.check_guards()
            if overflow:
                self._handle_overflow(stats, step)

            for s in range(prev, step):
                if cfg.log_every > 0 and s % cfg.log_every == 0:
                    loss = float(losses[s - prev])
                    now = time.perf_counter()
                    its = (cfg.log_every / max(now - window_start, 1e-9)
                           if s else 0.0)
                    window_start = now
                    n_alive = int(torch.sum(self.state.alive))
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
                    if self.watchdog.should_abort():
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
                    self.evaluate()

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
        (the SH degree's 1000, log, save, eval), so events land on block
        boundaries."""
        cfg = self.cfg
        periods = [1000]
        for p in (cfg.log_every, cfg.save_every, cfg.eval_every):
            if p > 0:
                periods.append(p)
        g = 0
        for p in periods:
            g = math.gcd(g, p)
        k = max(1, min(cfg.steps_per_call, g))
        while g % k:
            k -= 1
        return max(k, 1)

    def evaluate(self, sh_degree: int | None = None):
        raise _not_ported("Trainer.evaluate (train/metrics.py)", "A8")

    def gaussian_state(self) -> GaussianState:
        p = self.state.params
        return GaussianState(
            means=p["means"], quats=p["quats"], log_scales=p["log_scales"],
            opacity_logits=p["opacity_logits"], sh=p["sh"],
            alive=self.state.alive)

    def save_checkpoint(self, step: int, full: bool = True) -> str:
        """The live gaussians as a PLY and, with `full`, the whole train
        state as ckpt_<step>.npz (resumable)."""
        path = os.path.join(self.cfg.output_dir, f"model_{step:07d}.ply")
        arrays = self.gaussian_state().compact_arrays()
        write_gaussian_ply_numpy(
            path, arrays["means"], arrays["sh"], arrays["opacity_logits"],
            arrays["log_scales"], arrays["quats"])
        if full:
            from tpugs_torch.io.checkpoint import save_train_checkpoint

            save_train_checkpoint(
                os.path.join(self.cfg.output_dir, f"ckpt_{step:07d}.npz"),
                self.state, step)
        self.log(f"[{step}] checkpoint -> {path}")
        return path

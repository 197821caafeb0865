"""Benchmark of the port: train-step throughput (forward + backward + Adam)
on one NVIDIA GPU, the counterpart of the JAX package's bench.py.

    python3 bench_torch.py

Prints ONE JSON line with bench.py's keys and names: {"metric", "value",
"unit", "vs_baseline", "extra"}.

Primary metric / baseline: the reference's only measured end-to-end number
is 0.4 it/s at 489x272 with 50k gaussians of SH degree 3 on an RTX 3060
(BASELINE.md), 0.0532 Mpix/s of forward + backward training throughput.
The metric is Mpix/s at the same shape, and vs_baseline its ratio to that.
"extra" carries the second shape, garden-30k's (1297x840, 1M gaussians,
converged-scene footprints), for which no reference number exists.

The step is bench.py's, bare: render() with its defaults (the exact depth
presort up to 2^18 gaussians, the 2-key sort above), the L1 + SSIM loss
(lambda 0.2) against a fixed target, the gradients and Adam. The Trainer's
step adds a view draw, statistics and densification; this one does not.
The target is np.random.default_rng(0).random((h, w, 3)), not bench.py's
jax.random draw, so the absolute losses differ from bench.py's; the card
and the CPU see the same target.

The clock is bench.py's: one warm-up run of k steps (which also builds the
kernel library at first use), then `rounds` runs of k steps back to back,
each ending on one host read of its last loss, timed by time.perf_counter()
around the rounds. On the card a run of k steps is replays of the bare
step captured as one CUDA graph (tpugs_torch/train/graph.py; the warm-up
run's first two steps run eagerly before the capture), with its schedule
steps staged on the device by one copy, so nothing inside a run waits on
the host: the clock counts what bench.py's counts, device time, with the
host only at the run's end.

Knobs, read as bench.py reads them: TPUGS_TRAIN_CARRY=1 carries the
compositor attributes through the pair sort (the expand kernel's carry
mode); TPUGS_BENCH_SKIP_GARDEN=1 skips the second shape.

Runs on the card; measure_config(..., device="cpu") runs the kernels'
plain versions on the CPU, for tests at small shapes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from tpugs_torch.device import resolve_device
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_step
from tpugs_torch.train import graph
from tpugs_torch.train.loss import combined_loss
from tpugs_torch.utils.synthetic import synthetic_intrinsics, synthetic_params

NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
SH_DEGREE = 3
LAMBDA_SSIM = 0.2
TILE = 32
BASELINE_ITS = 0.4  # the reference at 489x272, 50k gaussians, RTX 3060


def carry_knob() -> bool:
    """TPUGS_TRAIN_CARRY=1: carry the compositor attributes through the
    pair sort (default off, as in bench.py)."""
    return os.environ.get("TPUGS_TRAIN_CARRY", "0") == "1"


@dataclasses.dataclass
class Measured:
    mpix_s: float  # rounds x k x W x H / seconds / 1e6
    its: float  # train steps per second
    seconds: float  # the timed rounds, host clock
    losses: np.ndarray  # [(rounds + 1) k]: every step's loss, warm-up first
    num_pairs: int  # at the final parameters
    max_tile_hits: int  # the busiest tile's entries there
    captures: int = 0  # graph captures (the card), each once per kernel
    replays: int = 0  # steps run as graph replays
    capture_seconds: float = 0.0


def bench_scene(img_w: int, img_h: int, n: int, scale_range=None,
                device="cpu"):
    """bench.py's scene: synthetic_params(n, seed=0) before the identity
    camera, all alive, synthetic intrinsics, black background. Returns
    (params, alive, viewmat, intrinsics, background)."""
    kw = {"scale_range": scale_range} if scale_range else {}
    params = synthetic_params(n, seed=0, device=device, **kw)
    return (params, torch.ones(n, dtype=torch.bool, device=device),
            torch.eye(4, device=device),
            synthetic_intrinsics(img_w, img_h, device=device),
            torch.zeros(3, device=device))


def bench_target(img_w: int, img_h: int, device="cpu") -> torch.Tensor:
    """The fixed target image [H, W, 3], from a seeded numpy generator."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.random((img_h, img_w, 3), dtype=np.float32)).to(device)


def make_bench_step(cfg: RasterConfig, alive, viewmat, intrinsics,
                    background, target, carry: bool = False):
    """bench.py's train_step: (params, adam_state, step) -> (params,
    adam_state, loss), the loss a detached scalar tensor; `step` a float32
    scalar tensor on the params' device. Its `graphed` dict holds run_k's
    graphs per device."""
    adam_cfg = AdamConfig()

    def train_step(params, adam_state, step):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        out = render(*[p[k] for k in NAMES], alive, viewmat, intrinsics, cfg,
                     SH_DEGREE, background, carry_attrs=carry)
        loss = combined_loss(out.color, target, LAMBDA_SSIM)
        grads = torch.autograd.grad(loss, [p[k] for k in NAMES])
        with torch.no_grad():
            params, adam_state = adam_step(adam_cfg, adam_state, params,
                                           dict(zip(NAMES, grads)), step)
        return params, adam_state, loss.detach()

    train_step.graphed = {}
    return train_step


class _GraphedSteps:
    """run_k's card path: the bare step over static params and Adam
    buffers, its schedule step a staged row (graph.BlockRunner)."""

    def __init__(self, train_step, device):
        self.train_step = train_step
        self.runner = graph.BlockRunner(device, 1)
        self.params = self.adam = None

    @staticmethod
    def _tensors(params, adam_state) -> list:
        return ([params[k] for k in NAMES] + [adam_state.m[k] for k in NAMES]
                + [adam_state.v[k] for k in NAMES] + [adam_state.count])

    def _adopt(self, params, adam_state):
        new = self._tensors(params, adam_state)
        if self.params is None or not graph.same_layout(
                new, self._tensors(self.params, self.adam)):
            self.runner.release()
            c = lambda d: {k: torch.empty_like(d[k]) for k in NAMES}  # noqa: E731
            self.params = c(params)
            self.adam = AdamState(m=c(adam_state.m), v=c(adam_state.v),
                                  count=torch.empty_like(adam_state.count))
        graph.load_buffers(self._tensors(self.params, self.adam), new)

    def body(self):
        params, adam, loss = self.train_step(self.params, self.adam,
                                             self.runner.row()[0])
        with torch.no_grad():
            for k in NAMES:
                self.params[k].copy_(params[k])
                self.adam.m[k].copy_(adam.m[k])
                self.adam.v[k].copy_(adam.v[k])
            self.adam.count.copy_(adam.count)
            self.runner.put_loss(loss)
            self.runner.advance()

    def __call__(self, params, adam_state, step0: float, k: int):
        self._adopt(params, adam_state)
        steps = np.float32(step0) + np.arange(k, dtype=np.float32)
        self.runner.stage(steps[:, None])
        self.runner.run(0, k, self.body)
        adam = AdamState(m=dict(self.adam.m), v=dict(self.adam.v),
                         count=self.adam.count)
        return dict(self.params), adam, self.runner.losses[:k].clone()


def run_k(train_step, params, adam_state, step0: float, k: int):
    """k steps at the schedule steps step0 + arange(k) (float32, as bench.py
    feeds Adam); returns (params, adam_state, the k losses [k]). On the card
    the steps are replays of the step captured as a CUDA graph: params and
    adam_state come back as the graph's static buffers, which the next call
    updates in place. On the CPU they run eagerly."""
    dev = params["means"].device
    if dev.type == "cuda":
        if dev not in train_step.graphed:
            train_step.graphed[dev] = _GraphedSteps(train_step, dev)
        return train_step.graphed[dev](params, adam_state, step0, k)
    steps = step0 + torch.arange(k, dtype=torch.float32, device=dev)
    losses = []
    for i in range(k):
        params, adam_state, loss = train_step(params, adam_state, steps[i])
        losses.append(loss)
    return params, adam_state, torch.stack(losses)


def assert_no_overflow(cfg: RasterConfig, params, alive, viewmat,
                       intrinsics, background):
    """bench.py's integrity check: render at `params` and assert that
    neither the pair capacity nor max hits overflowed (an overflow drops
    pairs, and the benchmark would measure less work than it claims).
    Returns the render's output."""
    with torch.no_grad():
        out = render(*[params[k] for k in NAMES], alive, viewmat, intrinsics,
                     cfg, SH_DEGREE, background)
    assert not bool(out.pair_overflow), (
        f"pair capacity {cfg.pair_capacity} overflowed "
        f"({int(out.num_pairs)} pairs)"
    )
    assert not bool(out.hit_overflow), (
        f"max_hits {cfg.max_hits_per_tile} overflowed "
        f"({int(out.max_tile_hits)} in busiest tile)"
    )
    return out


def measure_config(img_w, img_h, n, pair_capacity, max_hits,
                   scale_range=None, k=10, rounds=3, device="cuda",
                   carry=None) -> Measured:
    """Train-step Mpix/s for one workload shape (bench.py's clock);
    carry None reads TPUGS_TRAIN_CARRY."""
    dev = resolve_device(device)
    # Full float32 matmuls: the SSIM blur refuses TF32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = RasterConfig(img_h=img_h, img_w=img_w, tile_h=TILE, tile_w=TILE,
                       pair_capacity=pair_capacity,
                       max_hits_per_tile=max_hits)
    params, alive, viewmat, intr, bg = bench_scene(img_w, img_h, n,
                                                   scale_range, dev)
    adam_state = adam_init(params)
    train_step = make_bench_step(cfg, alive, viewmat, intr, bg,
                                 bench_target(img_w, img_h, dev),
                                 carry_knob() if carry is None else carry)

    params, adam_state, losses = run_k(train_step, params, adam_state, 0.0, k)
    float(losses[-1])  # warm-up and kernel build barrier
    history = [losses]
    t0 = time.perf_counter()
    for r in range(rounds):
        params, adam_state, losses = run_k(train_step, params, adam_state,
                                           float(k * (r + 1)), k)
        float(losses[-1])
        history.append(losses)
    dt = time.perf_counter() - t0

    # Checked on the final (most drifted) parameters.
    out = assert_no_overflow(cfg, params, alive, viewmat, intr, bg)
    its = rounds * k / dt
    g = train_step.graphed.get(dev)
    return Measured(mpix_s=its * img_w * img_h / 1e6, its=its, seconds=dt,
                    losses=torch.cat(history).cpu().numpy(),
                    num_pairs=int(out.num_pairs),
                    max_tile_hits=int(out.max_tile_hits),
                    captures=g.runner.captures if g else 0,
                    replays=g.runner.replays if g else 0,
                    capture_seconds=(sum(g.runner.capture_seconds) if g
                                     else 0.0))


# bench.py's two shapes. Primary: the reference benchmark's view (Truck at
# r=4). The capacity leaves ~18% headroom over its ~174k pairs, and max hits
# must exceed the busiest tile, or the front-K clamp truncates the measured
# work; both are asserted after the run.
PRIMARY = dict(img_w=489, img_h=272, n=50_000, pair_capacity=204_800,
               max_hits=4096, k=10, rounds=3)
# Secondary: garden-30k's scale (1297x840, 1M gaussians, converged-scene
# footprints); capacity 1.16x the scene's 2.106M pairs, a 512-multiple.
GARDEN = dict(img_w=1297, img_h=840, n=1_000_000, pair_capacity=2_453_504,
              max_hits=8192, scale_range=(0.002, 0.015), k=5, rounds=2)


def result_line(primary: Measured, garden: Measured | None) -> dict:
    """bench.py's JSON object from the two shapes' measurements (garden
    None: skipped)."""
    baseline_mpix_s = (BASELINE_ITS * PRIMARY["img_w"] * PRIMARY["img_h"]
                       / 1e6)
    return {
        "metric": "train_step_throughput_50k_sh3_489x272",
        "value": round(primary.mpix_s, 4),
        "unit": "Mpix/s (fwd+bwd+adam)",
        "vs_baseline": round(primary.mpix_s / baseline_mpix_s, 2),
        "extra": {
            "garden30k_shape_1297x840_1M_sh3": {
                "value": round(garden.mpix_s, 4),
                "unit": "Mpix/s (fwd+bwd+adam)",
                "it_per_s": round(garden.its, 2),
            }
        } if garden is not None else {"garden": "skipped"},
    }


def main() -> int:
    primary = measure_config(**PRIMARY)
    garden = None
    if os.environ.get("TPUGS_BENCH_SKIP_GARDEN", "0") != "1":
        garden = measure_config(**GARDEN)
    print(json.dumps(result_line(primary, garden)))
    return 0

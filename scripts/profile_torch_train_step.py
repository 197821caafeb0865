"""Where the time of one tpugs_torch training step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_train_step.py [--out chiprun_out/profile]

The step is the port's own (tpugs_torch.train.trainer.make_train_step) at
chip_smoke.py's phase 4 shape: the garden-30k shape (1M gaussians from
synthetic_params(seed=0, scale_range=(0.002, 0.015)), 1297x840, SH degree
3, tiles of 32, identity camera), render with gradients, L1 + SSIM against
a seeded target, backward, Adam. After 3 warm-up steps it prints

  - the step split into stages (render forward, loss, backward, Adam and
    the step's stats), marked by CUDA events recorded around the step's
    render, loss and Adam calls with a synchronisation at each mark, so
    the stages add up to a little more than an unsplit step;
  - a torch.profiler trace of 5 steps: the device's busy and idle shares
    of the window's wall time, and the top kernels and operators by device
    time;

and writes the profiler's full table under --out. Needs CUDA.

    python3 scripts/profile_torch_train_step.py --n-total 16777216

profiles chip_smoke.py's train-garden-2^24 cell instead: the same 1M
gaussians followed by gaussians behind the camera up to 2^24
(tpugs_torch.utils.synthetic.pad_behind_camera), whose backward takes the
classic branch.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, N = 1297, 840, 1_000_000
PAIR_CAPACITY, MAX_HITS = 2_453_504, 8192
WARMUP, SPLIT_STEPS, PROFILE_STEPS = 3, 5, 5


@contextlib.contextmanager
def stage_marks(trainer_mod, marks: list):
    """While the block runs, the train step's render, combined_loss and
    adam_step (looked up in the trainer module at each call) record a CUDA
    event into `marks` after a synchronisation: before render, after
    render, after the loss, before Adam and after it, five per step."""
    import torch

    def mark():
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def wrap(fn, before: bool):
        def marked(*args, **kw):
            if before:
                mark()
            out = fn(*args, **kw)
            mark()
            return out
        return marked

    orig = {name: getattr(trainer_mod, name)
            for name in ("render", "combined_loss", "adam_step")}
    trainer_mod.render = wrap(orig["render"], True)
    trainer_mod.combined_loss = wrap(orig["combined_loss"], False)
    trainer_mod.adam_step = wrap(orig["adam_step"], True)
    try:
        yield marks
    finally:
        for name, fn in orig.items():
            setattr(trainer_mod, name, fn)


def train_setup(dev, n_total: int = N):
    """The profiled step and its first state: make_train_step at the
    garden shape on N seeded gaussians, padded behind the camera up to
    n_total. Returns (step(state, t) -> (state, stats), state)."""
    import torch

    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import (TrainConfig, TrainState,
                                           initial_key, make_train_step)
    from tpugs_torch.utils.synthetic import (pad_behind_camera,
                                             synthetic_intrinsics_numpy,
                                             synthetic_params)

    cfg = RasterConfig(img_h=H, img_w=W, tile_h=32, tile_w=32,
                       pair_capacity=PAIR_CAPACITY, max_hits_per_tile=MAX_HITS)
    params = synthetic_params(N, seed=0, device=dev, scale_range=(0.002, 0.015))
    if n_total > N:
        params = pad_behind_camera(params, n_total)
    state = TrainState(
        params=params, alive=torch.ones(n_total, dtype=torch.bool, device=dev),
        adam=adam_init(params), adc=adc_init(n_total, dev),
        key=initial_key(0))
    # The scene extent sizes ADC's events only; a checkout from before the
    # step took it (the parent, under time_torch_e2e.py --repo) takes two.
    extent = ((1.0,) if "scene_extent" in
              inspect.signature(make_train_step).parameters else ())
    train_step = make_train_step(TrainConfig(densify_mode="none"), cfg,
                                 *extent)
    viewmat = torch.eye(4, device=dev)
    intr = torch.from_numpy(synthetic_intrinsics_numpy(W, H)).to(dev)
    target = torch.rand((H, W, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    def step(state, t):
        return train_step(state, target, viewmat, intr,
                          torch.tensor(float(t)), 3)

    return step, state


def device_attr(events) -> str:
    """The name of key_averages()' self device time in this torch."""
    return ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")


def print_profile(prof, units: int, wall_ms: float, unit: str):
    """The device's busy and idle shares of `wall_ms` (the profiled
    window's host time over `units` steps or frames), and the top kernels
    and operators by device time per unit; returns key_averages()."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    dev_attr = device_attr(events)
    dev_us = lambda e: getattr(e, dev_attr)
    # Kernels and copies carry device_type CUDA; operators (CPU events)
    # carry the device time of the kernels they launched.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA
                  and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print("profiled %d %ss: wall %.3f ms/%s, device busy %.3f ms/%s, "
          "busy share %.3f, idle share %.3f"
          % (units, unit, wall_ms / units, unit, busy_ms / units, unit,
             busy_ms / wall_ms, 1 - busy_ms / wall_ms))
    for title, rows in (("kernels and copies", kernels), ("operators", ops)):
        print(f"top {title} by device time per {unit} (ms, calls per {unit}, "
              f"name):")
        for e in rows[:15]:
            print("  %8.3f  %6.1f  %s" % (dev_us(e) / 1e3 / units,
                                          e.count / units, e.key[:90]))
    return events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--n-total", type=int, default=N,
                    help="gaussians in all: the 1M seen by the camera, the "
                         "rest behind it")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    from tpugs_torch.train import trainer as trainer_mod

    torch.cuda.reset_peak_memory_stats()
    n = args.n_total
    train_step, state = train_setup(dev, n)

    def step(state, t):
        return train_step(state, t)[0]

    t = 0
    for _ in range(WARMUP):
        state = step(state, t)
        t += 1
    marks = []
    with stage_marks(trainer_mod, marks):
        for _ in range(SPLIT_STEPS):
            state = step(state, t)
            t += 1
            end = torch.cuda.Event(enable_timing=True)
            end.record()  # after the step's stats
            marks.append(end)
    torch.cuda.synchronize()
    per_step = [marks[i:i + 6] for i in range(0, len(marks), 6)]
    stages = np.mean([[a.elapsed_time(b) for a, b in zip(row[:-1], row[1:])]
                      for row in per_step], axis=0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi)
    print("%d gaussians; stage ms (mean of %d steps, synchronised): render "
          "forward %.3f, loss %.3f, backward %.3f, adam %.3f, stats %.3f; sum "
          "%.3f; peak memory %.2f GiB"
          % (n, SPLIT_STEPS, *stages, stages.sum(),
             torch.cuda.max_memory_allocated() / 2**30))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state = step(state, t)
            t += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = print_profile(prof, PROFILE_STEPS, wall_ms, "step")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"train_step_table_{n}.txt"), "w") as f:
        f.write(events.table(sort_by=device_attr(events), row_limit=80))
    return 0


if __name__ == "__main__":
    sys.exit(main())

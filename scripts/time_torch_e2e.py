"""The three end-to-end times of chip_smoke.py, with more frames and steps,
on one NVIDIA GPU:

    python3 scripts/time_torch_e2e.py [--repo DIR] [--frames 40] [--steps 30]
                                      [--large-steps 8]

  - render: the render CLI (tpugs_torch.apps.render.main) on chip_smoke.py's
    scene and arguments (1M gaussians of SH degree 3, 1920x1080), --frames
    orbit frames, each frame's ms as the CLI prints it (frame 0, the
    warm-up, dropped);
  - train: the train step of scripts/profile_torch_train_step.py (the
    garden shape, 1M gaussians), 3 warm-up and --steps timed steps (CUDA
    events);
  - large: the same step at N = 2^24 (the 1M gaussians and the rest behind
    the camera: the classic backward), 2 warm-up and --large-steps timed.

Each train list comes with its peak memory (max_memory_allocated from the
set-up to the last step).

The set-up comes from chip_smoke.py and the profile script of this
checkout; the tpugs_torch package timed is the one under --repo (default:
this checkout), so two checkouts are compared in one call by running this
script once for each, in turns. Prints the card (nvidia-smi) and one JSON
line with every frame's and step's ms, each list's median and quartiles,
and the losses of the timed steps. Needs CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import chip_smoke  # noqa: E402  (imports tpugs_torch only when called)
import profile_torch_train_step as profile  # noqa: E402


def summary(ms: list[float]) -> dict:
    import numpy as np

    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"ms": ms, "median": float(med), "q1": float(q1), "q3": float(q3)}


def render_frames(tmp: str, frames: int) -> list[float]:
    from tpugs_torch.apps import render as render_app

    _, ply = chip_smoke.cli_scene(tmp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = render_app.main(chip_smoke.cli_argv(
            ply, os.path.join(tmp, "frames"), frames + 1))
    if rc != 0:
        raise RuntimeError(f"render CLI returned {rc}")
    ms = [float(m) for m in re.findall(r"frame \d+: .* ms ([\d.]+)",
                                       out.getvalue())]
    if len(ms) != frames + 1:
        raise RuntimeError(f"render CLI printed {len(ms)} frame lines")
    return ms[1:]


def train_steps(n_total: int, warmup: int, steps: int):
    """-> (ms of each timed step, loss of each timed step, peak GiB
    allocated from the set-up to the last step)."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    step, state = profile.train_setup(dev, n_total)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms, losses = [], []
    for i in range(warmup + steps):
        ev0.record()
        state, stats = step(state, i)
        ev1.record()
        torch.cuda.synchronize()
        loss = float(stats.loss)
        if not np.isfinite(loss) or bool(stats.pair_overflow):
            raise RuntimeError(f"step {i}: loss {loss}, overflow "
                               f"{bool(stats.pair_overflow)}")
        ms.append(ev0.elapsed_time(ev1))
        losses.append(loss)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    del state, step
    torch.cuda.empty_cache()
    return ms[warmup:], losses[warmup:], peak_gib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT,
                    help="checkout whose tpugs_torch is timed")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--large-steps", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    import tpugs_torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        render = render_frames(tmp, args.frames)
    train, train_loss, train_peak = train_steps(profile.N, 3, args.steps)
    large, large_loss, large_peak = train_steps(1 << 24, 2, args.large_steps)
    print(json.dumps({"package": os.path.dirname(tpugs_torch.__file__),
                      "render_cli_ms_per_frame": summary(render),
                      "train_1m_ms_per_step": summary(train),
                      "train_1m_losses": train_loss,
                      "train_1m_peak_gib": train_peak,
                      "train_2p24_ms_per_step": summary(large),
                      "train_2p24_losses": large_loss,
                      "train_2p24_peak_gib": large_peak}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profiling and timing, as in tpugs/utils/profiling.py, on torch.profiler
and CUDA events:

- `trace()` records a block with torch.profiler (CPU activities, and CUDA
  ones where a card is present) and writes a Chrome trace into a directory
  (open it in Perfetto or chrome://tracing);
- `device_time()` gives the seconds per iteration of a step function:
  CUDA events on the card, the host clock on the CPU;
- `StageTimer` adds up named host-side stage timings for logging.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; on leaving it (also by an exception)
    writes log_dir/trace_<pid>_<ns>.json and sets the profile's
    `trace_path` to it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


def _device(carry) -> torch.device:
    """The device of the first tensor in a carry of tensors, dicts, lists,
    tuples and dataclasses."""
    stack = [carry]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dataclass_fields__"):
            stack.extend(getattr(x, f) for f in x.__dataclass_fields__)
    raise ValueError("device_time: the carry holds no tensor")


def device_time(step_fn: Callable, carry, k: int = 10, rounds: int = 2) -> float:
    """Seconds per iteration of `carry = step_fn(carry, it)`, it = 0 .. k-1
    as a float32 tensor on the carry's device: one warm-up round of k, then
    `rounds` rounds timed together, with CUDA events on the card (the
    device time of the queued work, waited for once at the end) or the
    host clock on the CPU."""
    dev = _device(carry)
    its = torch.arange(k, dtype=torch.float32, device=dev)

    def run(c):
        for i in range(k):
            c = step_fn(c, its[i])
        return c

    carry = run(carry)  # warm-up
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record(stream)
        for _ in range(rounds):
            carry = run(carry)
        t1.record(stream)
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3 / (rounds * k)
    t0 = time.perf_counter()
    for _ in range(rounds):
        carry = run(carry)
    return (time.perf_counter() - t0) / (rounds * k)


class StageTimer:
    """Named wall-clock accumulators for host-side stages."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t / c * 1e3:.1f} ms avg x{c}")
        return "\n".join(lines)

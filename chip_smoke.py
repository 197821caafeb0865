#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpugs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each under a watchdog that ends a hung run with a stack trace and
a nonzero exit:
  0. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  1. build: the one kernel library, one nvcc call
     (tpugs_torch/cuda_lib);
  2. kernels against their plain PyTorch versions on a 20k-gaussian scene
     at 256x192, tiles of 16 and 32: expand (also in carry mode) and
     align-copy bit-identical, the forward compositor within the stated
     tolerances;
  2b. the same scene rendered with gradients under a seeded L1 + SSIM loss:
     the backward compositor and the sorted segment sum bit-identical to
     their plain versions on the inputs the backward gave them, and the
     whole render() gradient on the card against the same on the CPU;
  3. the render CLI itself (tpugs_torch.apps.render.main), 3 frames at
     1920x1080 of a 1M-gaussian SH-degree-3 PLY, no overflow, every frame
     through all three forward kernels; then each of those kernels timed
     at that frame's shapes beside its bound, its plain version and a
     library call, and held against its plain version on the whole frame;
  4. the port's train step (tpugs_torch.train.trainer.make_train_step) at
     the garden shape (1M gaussians, 1297x840, SH 3, tiles of 32): render
     with gradients, L1 + SSIM against a seeded target, backward, Adam; 2
     warm-up and 10 timed steps, each through the five kernels of the
     sorted path, no overflow, finite loss and gradients; then those
     kernels held against their plain versions on step 0's inputs and
     timed there beside their bounds, and the gid sort timed;
  4b. one garden frame's gradients three ways: the sorted backward, the
     classic branch (SORTED_SEGRED_MIN raised: the entry-major backward
     compositor K4b and the interval segment sum K6) and the scatter-add
     gradient of render(need_grads=False) (K4b); classic and scatter held
     against sorted (rtol 1e-3 + 1e-4 max|g| on >= 99.9% of elements), K4b
     against K4 transposed (bit-identical), two scatter runs compared;
  4c. render(carry_attrs=True) at the render CLI's frame 0 and at the train
     frame: images equal to the gathered path's, the expand kernel's carry
     mode (K1b) bit-identical to its plain version, both frames timed both
     ways;
  4d. the train step at N = 2^24 (the garden frame's 1M gaussians and
     2^24 - 1M more behind the camera): the classic branch, K4b and K6 once
     per step, K4 and K5 never; 2 warm-up and 5 timed steps, peak memory
     (step 0's captured kernel inputs held through the steps included);
     K4b, K6 and K1 held against their plain versions on step 0's inputs
     (bit-identical) and timed there, K6 beside torch.segment_reduce,
     index_add_ and the zeroing of its output, with the lengths of the
     intervals it summed, K1 also on the same inputs cut to their first 1M
     gaussians; then binning.expand_inputs (the expand kernel's tables)
     timed at 1M and 2^24;
  5. the train CLI (tpugs_torch.apps.train.main, --no-densify) for 20 steps
     on a 4-view 1297x840 GT dataset of a 1M-gaussian model with 1M sparse
     points; finite losses, no overflow left, every step through the sorted
     path's five kernels, and its last checkpoint loads;
  6. densification and evaluation (train-densify): a 16-view 1297x840 GT
     dataset of the 1M model with 140,000 sparse points, capacity 2^22.
     The train CLI with no densify flag (ADC) for 120 steps (densify every
     20 from 20 to 100, an opacity reset at 60, size pruning after it, an
     evaluation of the 2 test views at 60): events that clone or split
     and that prune, N grown, the checkpoint's alive count the last
     event's N, K1-K5 once per step and K1-K3 once per eval render, finite
     losses, PSNR and SSIM, no overflow left; then --mcmc for 100 steps
     (relocate and grow every 20 from 20): relocations, N grown by
     grow_factor, K1-K5 once per step. The first ADC event's state, and
     the first and last MCMC events' states, go through adc_densify and
     relocate + grow on the card and on the CPU with the same draws:
     masks, stats and slot assignment identical, params within 2e-5. Times
     each event (CUDA events), the ADC step before the first event and
     after the last, each eval view; counts the host syncs of one ADC
     step against one step without densification (equal), and of one
     densify and one relocate event (none).
  7. the viewer (after phase carry, on the render CLI's 1M-gaussian SH-3
     scene at 1920x1080, tile 32): the anchor build (build_frame_cache)
     launches K1 and K2 once and K3 never, its pair count and busiest tile
     are render(presort="qkey")'s, and the zero-delta cached frame
     (render_cached, under torch's sync debug mode) is that render's, bit
     for bit; a 16-frame drag in 0.05 degree steps through
     OfflineRenderer.render_interactive re-anchors past 0.25 degrees and
     launches K3 alone on each frame that keeps its anchor; the PSNR
     of the cached frame against the exact one falls from 0.1 to 1
     degree; the exact frame,
     the anchor build, the cached frame and a re-anchor every 8 frames are
     timed; drags at the web page's rates (1, 2 and 4 mouse pixels per
     round trip, 1/300 rad a pixel) at 1920x1080 and at the page's
     960x512 drag frames, each timed against the exact frame of its size,
     re-anchor every frame from 2 pixels (K1, K2 and K3 once each); then
     ViewerServer answers real HTTP on 127.0.0.1 (the page,
     /info, four drag frames, a release, depth and heatmap), its JPEGs at
     the snapped sizes;
  8. tools (after phase train-densify, on the two GT datasets): `python -m
     tpugs_torch.apps.info --json` names the card, dump_points writes the
     train-cli dataset's points and cameras, the native parse of its
     points3D.bin equals the numpy parse, and the train CLI writes a
     torch.profiler trace of 3 steps on the densify dataset;
  9. the mesh (parallel/, after phase tools) at the train-step frame:
     (a) data=1,gauss=1 in this process on an NCCL world of size 1: the
     image of the tile-sharded render equal (within 5e-7) to the
     single-device render, step 0 of dist_train.make_dist_train_step (the
     exchange capacity auto-tuned) with its normalised gradient (Adam's
     first moment) against the single-device step's by the card-vs-CPU
     rule, K1-K5 once per step, the mesh step timed beside the
     single-device step; (c) on the same world,
     dist_train.make_dist_multi_step's blocks through the captured graph
     (every axis of size 1): two blocks of 10 at the garden frame (ADC) and
     at bench-50k (MCMC), each bit-equal to as many eager mesh steps
     (losses, mesh statistics, every tensor of the state), K1-K5 once per
     replayed step in the profiler, capture seconds, pool bytes, the busy
     share of the replayed block, ms per step of the graphed block, the
     eager mesh steps and the single-device graphed block in turns, and
     the eager mesh step under sync debug mode "error"; (d) NCCL inside a
     CUDA graph on the world-1 group itself: all_to_all_single,
     all_gather_into_tensor and all_reduce (SUM and MAX, f32 and int64)
     at the garden step's shapes, captured and replayed equal to the eager
     collectives; (e) the train CLI with --mesh data=1,gauss=1 under
     `torchrun --standalone` on the densify dataset, 8 steps, through the
     graphed block (`chip_smoke.py --mesh-cli` prints the graph counts);
     (b) data=1,gauss=2 as two spawned ranks on the one card (NCCL refuses
     two ranks on one device, so the phase names gloo, which takes card
     tensors through host memory), the same checks on each rank's shard,
     rank 1 at row offset 14 with its K1 (row-clipped rects), K2, K3, K4
     and K5 held against their plain versions and timed; the exchange's
     bytes per rank and step and the send capacity printed; (f) each
     rank's make_dist_multi_step of 4 steps, eager on gloo, equal to its
     own eager steps;
  10. oracles (after phase viewer): (a) the pre-aligned path at the garden
     train frame, bin_gaussians_aligned's layout equal to
     align_segments(bin_gaussians(...)) on the card, CompositePre's image
     equal to the kernel route's and its gradients held to the sorted
     path's by the card-vs-CPU rule, K3 and K4b launched once each and
     held against their plain versions, both paths' forward + backward
     timed; (b) render(presort="fast") at the render CLI's frame 0 against
     "exact" (max abs err, PSNR, sorted pairs that hold another gaussian),
     K1-K3 once, ms per frame beside "exact" and "auto"; (c)
     render(compositor="scan") on phase 2's scene (20k, 256x192, tile 16)
     against the kernel route on the card and the scan on the CPU, image
     and gradients, no kernel launched, timed; (d) the dense oracle on a
     300-gaussian 64x48 scene against the scan on the card;
  11. bench (after phase train-step): tpugs_torch.bench (bench_torch.py)
     at bench.py's two shapes, carry off: 489x272 with 50k gaussians (the
     exact presort with the packed key) and the garden shape with 1M (the
     2-key sort), measure_config's own clock, bench_torch.py's JSON line,
     it/s, Mpix/s, pairs against the pair capacity and the busiest tile
     against max hits; K1-K5 once per step and nothing else; K1-K5 held
     against their plain versions on the 50k bench's step-0 inputs; the
     50k shape again with carry on (K1b in K1's place, once per step; the
     losses equal carry off's; K1b held against its plain version); the
     50k bench's first 2 steps on the card and on the CPU (losses rtol
     1e-4, params within steps x 2 x lr on >= 99.9% of elements); and the
     device's busy share over one timed 50k round (torch.profiler) with the
     host syncs of one step, printed only. Its runs go through run_k's
     captured CUDA graph: a wrapper counts a kernel once at the capture
     and not at a replay, so a graphed run's launches are its counts less
     the captures plus the replays (`executed`), as in phases 5 and 6;
  12. graph (after phase bench): the train step as a captured CUDA graph
     (tpugs_torch/train/graph.py) at bench.py's two shapes. The Trainer's
     ADC step (and the bench's bare step) eagerly under sync debug mode
     "error"; make_train_multi_step's second block of 6 steps, all graph
     replays, against 6 eager make_train_step calls from a copy of the
     same state: losses and every tensor of the state bit-equal (ADC at
     both shapes, MCMC at 50k: the graph's generator re-seeded per step
     draws the eager step's noise), K1-K5 six times in the block's
     profile (torch.profiler's kernel events), capture seconds, graph
     pool bytes and peak memory, the block's and the eager steps' ms in
     turns; the bench through the graph (measure_config) and through the
     eager loop in turns, losses of every step bit-equal, Mpix/s of both;
     the busy share of a profiled 50k round both ways; K1b in K1's place
     in a carried graph round;
Every kernel is timed twice (CUDA events, 10 launches): as the main path
calls it, through its wrapper (`ms`), and alone, its C function launched
again on the same checked inputs into the same outputs (`alone_ms`). The
wrappers of the align-copy, the interval sum and the two compositors, whose
guards run on the card, and of the expansion are also called once under
torch's sync debug mode, which fails them on any host read, and no kernel
may have set its guard word by the end. The compositors' rows also print
step1 lines: the busiest tile alone (every other tile's segment emptied),
the (pixel, entry) pairs evaluated at tile, sub-tile and warp granularity
against those needed, and the distribution of tile walks; so do the
expand rows (K1 on the render, train and 2^24 frames, K1b on both carried
frames): the gaussians that own no slot, slots per owner, the lane use of
a warp per gaussian and the slot spans of the kernel's chunks.
Prints a {"kernels": [...]} line with the eight kernels, each with its
launches on its own slice's main path (K1-K5: the train step; K4b, K6: the
2^24 train step; K1b: the carried train frame) and on every path driven
(the ADC and MCMC CLI runs and the ADC run's evaluation, the viewer's
anchor build and its drag, the mesh steps of (a) and of each rank of (b)
and the replayed mesh blocks of (c),
the pre-aligned, fast-presort and scan frames of phase oracles, the
steps of phase bench's three runs and phase graph's profiled blocks and
rounds among them),
then the nvidia-smi line and, only when every phase passed,
{"ok": true, "device": {...}} as the last line.
"""
from __future__ import annotations

import collections
import contextlib
import faulthandler
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ATOL = 1e-5  # compositor color and T: ulp-scale drift of summation order
MIN_MATCH = 0.999  # compositor n_contrib / k_last: share of equal pixels

GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4  # card vs CPU render() gradients,
MIN_GRAD_MATCH = 0.999  # per element: projection's ulps between devices can
#                         move a rare rect or cull boundary, and with it one
#                         gaussian's gradient

# The small scenes' pair capacity (20k gaussians at 256x192: 79,769 pairs
# at tiles of 16).
SMALL_PAIR_CAPACITY = 1 << 17
CLI_N = 1_000_000
CLI_W, CLI_H = 1920, 1080
CLI_FRAMES = 3
# The pair arrays are this long whatever the frame's count (static, as the
# reference's): 2.7x the 1M scene's 1.54M pairs at frame 0.
CLI_PAIR_CAPACITY = 1 << 22
CLI_MAX_HITS = 1 << 20

# The garden-30k training shape of bench.py's second configuration.
TRAIN_N = 1_000_000
TRAIN_W, TRAIN_H = 1297, 840
TRAIN_PAIR_CAPACITY = 2_453_504
TRAIN_MAX_HITS = 8192
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_CLI_VIEWS, TRAIN_CLI_STEPS = 4, 20
# The large-scene train step: the garden shape at 2^24 gaussians, the
# first N that takes the classic backward branch.
LARGE_N = 1 << 24
LARGE_WARMUP, LARGE_STEPS = 2, 5
# Densification and evaluation at the garden shape: a GT dataset of the 1M
# model in 16 views (views 0 and 8 the test split), trained from 140,000
# sparse points (the order of a Mip-NeRF 360 scene's SfM cloud) at a
# capacity of 2^22, as a run sized for a real scene would be.
DENSIFY_VIEWS, DENSIFY_POINTS, DENSIFY_CAPACITY = 16, 140_000, 1 << 22
ADC_STEPS, MCMC_STEPS = 120, 100
# densify_until 120 with the default skip_final_reset lets the reset at 60
# fire (it leaves a full period of events); the events are at 20..100.
ADC_CONFIG = {"eval_every": 60, "adc": {
    "densify_from": 20, "densify_every": 20, "densify_until": 120,
    "opacity_reset_every": 60}}
MCMC_CONFIG = {"mcmc": {"relocate_from": 20, "relocate_every": 20}}
EVENT_RTOL = 2e-5  # card vs CPU event params: exp, log, pow ulps
# The viewer on the render CLI's scene and frame-0 camera (1920x1080, tile
# 32, the viewer's default capacities grown by its first frame): a drag of
# 16 frames turning 0.05 degrees each, the cached frame's drift against the
# exact one at four angles, and a re-anchor every 8 frames.
VIEWER_DRAG_FRAMES, VIEWER_STEP_DEG = 16, 0.05
VIEWER_PSNR_DEG = (0.1, 0.25, 0.5, 1.0)
VIEWER_REANCHOR_EVERY = 8
# The web page's drag (viewer/server.py): a mouse move of dx pixels turns
# the orbit dx / 300 rad, and the page posts one frame per round trip, at
# half size while dragging (960x512 here). A frame turns by the mouse's
# pixels per round trip over 300: 0.191 degrees a pixel, so from 2 pixels
# per round trip every frame passes the 0.25-degree rule and re-anchors.
VIEWER_PAGE_RAD_PER_PX = 1.0 / 300.0
VIEWER_PAGE_PX = (1, 2, 4)  # mouse pixels per round trip
VIEWER_PAGE_FRAMES = 8
TRACE_STEPS = 3  # the train CLI's steps under --trace-dir
PORT_KERNEL_NAMES = ("expand_kernel", "align_copy_kernel",
                     "composite_fwd_kernel", "composite_bwd_kernel",
                     "segreduce_sorted_kernel", "segreduce_interval_kernel")

_T0 = time.perf_counter()


class Phase:
    """Prints one line with the phase's elapsed seconds; arms a watchdog
    that dumps every thread's stack and exits 1 after `budget` seconds."""

    def __init__(self, name: str, budget: float):
        self.name, self.budget = name, budget

    def __enter__(self):
        faulthandler.dump_traceback_later(self.budget, exit=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        faulthandler.cancel_dump_traceback_later()
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[phase {self.name}] {status} in {dt:.1f} s "
              f"(total {time.perf_counter() - _T0:.1f} s)", flush=True)
        return False


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# One kernel's row: `ms` times the wrapper as the main path calls it
# (checks, allocation, launch), `alone_ms` the launch alone (below);
# `lib` names the library call that `lib_ms` times, `extra` holds further
# numbers of the row (a second yardstick).
Row = collections.namedtuple(
    "Row", "name ms alone_ms plain_ms nbytes ops lib_ms lib extra",
    defaults=(None, None, None))


def host_ms(fn, reps: int = 100) -> float:
    """Host time of fn() in ms per call over `reps` calls that do not wait
    for the device: where it exceeds the kernel's device time, `ms` (the
    wrapper as called, back to back) measures the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def timed_alone(wrapper_call) -> float:
    """ms (cuda_ms) of the wrapper's one launch made again through the
    library's C function, recorded while wrapper_call() runs: the same
    inputs and outputs, none of the wrapper's checks and no allocation."""
    from tpugs_torch import cuda_lib

    real = cuda_lib.lib()
    calls = []

    class Recorder:
        def __getattr__(self, name):
            fn = getattr(real, name)

            def call(*args):
                calls.append((fn, args))
                return fn(*args)

            return call

    cuda_lib._lib = Recorder()
    try:
        keep = wrapper_call()  # owns the outputs the launch writes
    finally:
        cuda_lib._lib = real
    check(len(calls) == 1, f"{len(calls)} library calls, expected 1")
    fn, args = calls[0]

    def launch():
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{fn.__name__}: CUDA error {code} at launch")

    ms = cuda_ms(launch)
    del keep
    return ms


def without_sync(call, what: str):
    """call() under torch's sync debug mode "error", which raises on any
    operation that makes the host wait for the device: the wrapper of a
    kernel whose guard moved onto the card must not."""
    import warnings

    import torch

    with warnings.catch_warnings():  # "a prototype feature"
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
    try:
        return call()
    except RuntimeError as e:
        raise AssertionError(f"{what} synchronised with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


# name -> (module under tpugs_torch.ops, wrapper, its launch counter,
# source, the TPU kernel it replaces): one row per kernel of the table in
# PERF.md; a wrapper with two modes counts each mode on its own counter.
KERNELS = {
    "expand": ("expand", "expand_pairs", "launches",
               "tpugs_torch/csrc/expand.cu", "tpugs/ops/pallas/expand.py:82"),
    "expand_carry": ("expand", "expand_pairs", "launches_carry",
                     "tpugs_torch/csrc/expand.cu",
                     "tpugs/ops/pallas/expand.py:82"),
    "align_copy": ("pack", "align_copy", "launches",
                   "tpugs_torch/csrc/align_copy.cu",
                   "tpugs/ops/pallas/pack.py:100"),
    "composite_fwd": ("composite_t", "composite_forward", "launches",
                      "tpugs_torch/csrc/composite_fwd.cu",
                      "tpugs/ops/pallas/composite_t.py:180"),
    "composite_bwd": ("composite_t", "composite_backward", "launches",
                      "tpugs_torch/csrc/composite_bwd.cu",
                      "tpugs/ops/pallas/composite_t.py:343"),
    "composite_bwd_entry": ("composite_t", "composite_backward",
                            "launches_entry_major",
                            "tpugs_torch/csrc/composite_bwd.cu",
                            "tpugs/ops/pallas/composite_t.py:343"),
    "segreduce": ("segreduce", "segment_sum_sorted", "launches",
                  "tpugs_torch/csrc/segreduce.cu",
                  "tpugs/ops/pallas/segreduce.py:200"),
    "segreduce_interval": ("segreduce", "segment_reduce", "launches",
                           "tpugs_torch/csrc/segreduce.cu",
                           "tpugs/ops/pallas/segreduce.py:54"),
}
# The path each kernel's `launches` in the kernels line is read from: the
# main path of the slice that ported it.
MAIN_PATH = {"expand": "train_step", "align_copy": "train_step",
             "composite_fwd": "train_step", "composite_bwd": "train_step",
             "segreduce": "train_step",
             "composite_bwd_entry": "large_train_step",
             "segreduce_interval": "large_train_step",
             "expand_carry": "carry_train_frame"}


def _counter(name: str):
    """(wrapper, counter attribute) of a kernel."""
    import importlib

    mod, fn, counter = KERNELS[name][:3]
    return getattr(importlib.import_module(f"tpugs_torch.ops.{mod}"), fn), counter


def reset_launches():
    from tpugs_torch.train.graph import BlockRunner

    for name in KERNELS:
        setattr(*_counter(name), 0)
    BlockRunner.captures_total = BlockRunner.replays_total = 0


def read_launches() -> dict:
    return {name: getattr(*_counter(name)) for name in KERNELS}


def graph_totals() -> tuple:
    """(captures, replays) of every CUDA graph runner since the last
    reset_launches()."""
    from tpugs_torch.train.graph import BlockRunner

    return BlockRunner.captures_total, BlockRunner.replays_total


def executed(launches: dict, path, captures: int, replays: int) -> dict:
    """The kernels a graphed run ran: a wrapper counts each kernel of its
    step once when a capture records it and never on a replay, and every
    replay runs each kernel of `path` once (phase graph counts them in the
    profiler's kernel events), so each kernel of `path` ran its count less
    the captures plus the replays."""
    return {k: v - captures + replays if k in path else v
            for k, v in launches.items()}


@contextlib.contextmanager
def capturing(module, name: str, when=lambda args, kw: True):
    """Record the positional arguments of the first call of module.name for
    which when(args, kwargs) holds, while the block runs. A wrapper counts
    its launches on the module attribute, so the counts move to the
    recorder and back."""
    orig = getattr(module, name)
    calls = []

    def recorder(*args, **kw):
        if not calls and when(args, kw):
            calls.append(args)
        return orig(*args, **kw)

    counters = {k: v for k, v in vars(orig).items() if k.startswith("launches")}
    vars(recorder).update(counters)
    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, orig)
        for k in counters:
            setattr(orig, k, getattr(recorder, k))


SORTED_PATH = ("expand", "align_copy", "composite_fwd", "composite_bwd",
               "segreduce")  # a default train step's kernels
CLASSIC_PATH = ("expand", "align_copy", "composite_fwd",
                "composite_bwd_entry", "segreduce_interval")


def check_launches(launches: dict, path, runs: int, what: str):
    """Each kernel of `path` launched once per run, every other none."""
    for name, count in launches.items():
        want = runs if name in path else 0
        check(count == want, f"{name} launched {count} times in {runs} "
              f"{what} (expected {want})")


def entry_major(args, kw) -> bool:
    return kw.get("transposed_out") is False


def carry_mode(args, kw) -> bool:
    return len(args) > 7 and args[7] is not None


def close_share(a, b) -> float:
    """Share of elements of a within GRAD_RTOL |b| + GRAD_ATOL_REL max|b|."""
    tol = GRAD_RTOL * b.abs() + GRAD_ATOL_REL * float(b.abs().max())
    return float(((a - b).abs() <= tol).float().mean())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build():
    from tpugs_torch import cuda_lib

    path = cuda_lib.build()
    cuda_lib.lib()
    # nvcc's report: this process's build, or the one that built this hash.
    log = cuda_lib.build_log or (path.parent / "nvcc.log").read_text()
    regs = re.findall(r"Function properties for (\S+)|Used (\d+) registers",
                      log)
    used = [int(r[1]) for r in regs if r[1]]
    spills = re.findall(r"(\d+) bytes spill stores", log)
    print(f"built {os.path.relpath(path)} in "
          f"{cuda_lib.build_seconds if cuda_lib.build_seconds else 0:.1f} s; "
          f"registers per thread {used}, spill stores {spills}", flush=True)
    # ptxas -v per entry function: registers, shared memory, spills.
    for fn, body in re.findall(r"Compiling entry function '(\S+)' for "
                               r"'\S+'\n(.*?)(?=Compiling entry|\Z)",
                               log, re.S):
        if "composite" in fn or "expand" in fn:
            regs = re.search(r"Used (\d+) registers", body)
            smem = re.search(r"(\d+) bytes smem", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            print(f"ptxas {fn}: {regs.group(1) if regs else '?'} registers, "
                  f"{smem.group(1) if smem else '?'} bytes smem, "
                  f"{spill.group(1) if spill else '?'} bytes spill stores",
                  flush=True)
    for tile in (16, 32, 64):
        g, n = cuda_lib.cluster_occupancy(0, tile, tile)
        print(f"backward compositor at tiles of {tile}: clusters of {g} "
              f"sub-tile blocks, at most {n} active at once "
              f"(cudaOccupancyMaxActiveClusters)", flush=True)


def _scene(dev, n, w, h, seed, **kw):
    import torch

    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                             synthetic_params)

    p = synthetic_params(n, seed=seed, device=dev, **kw)
    intr = torch.as_tensor(synthetic_intrinsics_numpy(w, h), device=dev)
    return project_gaussians(
        p["means"], p["quats"], p["log_scales"], p["opacity_logits"], p["sh"],
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.eye(4, device=dev), intr, w, h, 3)


def compare_compositor(got, ref):
    """(max abs err of color and T, share of equal n_contrib, of equal
    k_last); raises past the tolerances."""
    import torch

    (c, t, nc, kl), (c0, t0, nc0, kl0) = got, ref
    err = max(float((c - c0).abs().max()), float((t - t0).abs().max()))
    m_nc = float((nc == nc0).float().mean())
    m_kl = float((kl == kl0).float().mean())
    check(bool(torch.isfinite(c).all()) and bool(torch.isfinite(t).all()),
          "compositor output not finite")
    check(err <= ATOL, f"compositor color/T max abs err {err} > {ATOL}")
    check(m_nc >= MIN_MATCH and m_kl >= MIN_MATCH,
          f"compositor n_contrib/k_last match {m_nc}/{m_kl} < {MIN_MATCH}")
    return err, m_nc, m_kl


def phase_kernels(dev, errs):
    """Each kernel against its plain version, small scene, tiles 16 and 32."""
    import torch

    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops import composite_t, expand, pack
    from tpugs_torch.ops.rasterize_tiled import RasterConfig

    w, h = 256, 192
    proj = _scene(dev, 20_000, w, h, seed=0)
    for tile in (16, 32):
        full = int(B.expand_inputs(proj, w, h, tile, tile, 1 << 24).total)
        # Capacities past the total (a sentinel tail) and below it.
        for cap, qbits, presort in ((2 * full, 0, False), (full // 2, 0, False),
                                    (2 * full, 32, False), (2 * full, 0, True)):
            pr = B.presort_by_depth(proj)[1] if presort else proj
            ex = B.expand_inputs(pr, w, h, tile, tile, cap, presort, qbits)
            args = (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile)
            k_out = expand.expand_pairs(*args)
            p_out = expand.expand_pairs_plain(*args)
            for a, b in zip(k_out, p_out):
                check(torch.equal(a, b), f"expand differs (tile {tile}, cap {cap})")
            atab = pack.gaussian_attrs(pr.means2d, pr.conic, pr.rgb,
                                       pr.opac).T.contiguous()
            for a, b in zip(expand.expand_pairs(*args, atab),
                            expand.expand_pairs_plain(*args, atab)):
                check(torch.equal(a, b), f"expand in carry mode differs "
                      f"(tile {tile}, cap {cap})")
            bk, bp = (B.sort_pairs(*o, ex.num_tiles, proj.depths.shape[0],
                                   ex.total, cap, presort, ex.qbits)
                      for o in (k_out, p_out))
            for f in ("tile_start", "tile_stop"):
                check(torch.equal(getattr(bk, f), getattr(bp, f)),
                      f"binning {f} differs")
            if not qbits:  # the qkey sort is unstable: same-bin order free
                check(torch.equal(bk.pair_gauss, bp.pair_gauss),
                      "sorted pair_gauss differs")
        errs["expand"] = errs["expand_carry"] = 0.0
        cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=SMALL_PAIR_CAPACITY,
                           max_hits_per_tile=1 << 20)
        b = B.bin_gaussians_expand_kernel(proj, w, h, tile, tile, cfg.pair_capacity)
        astart, astop, counts = pack.aligned_offsets(b.tile_start, b.tile_stop)
        pal = pack.aligned_length(astart, counts)
        attr_c = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                         proj.rgb, proj.opac, b.pair_gauss.shape[0])
        attr = pack.align_copy(attr_c, b.tile_start, astart, counts, pal)
        ref = pack.align_copy_plain(attr_c, b.tile_start, astart, counts, pal)
        check(torch.equal(attr, ref), f"align-copy differs (tile {tile})")
        errs["align_copy"] = 0.0
        got = composite_t.composite_forward(cfg, astart, astop, attr)
        ref = composite_t.composite_forward_plain(cfg, astart, astop, attr)
        err, m_nc, m_kl = compare_compositor(got, ref)
        errs["composite_fwd"] = max(errs.get("composite_fwd", 0.0), err)
        torch.cuda.synchronize()
        print(f"tile {tile}: {full} pairs, expand (also in carry mode) + "
              f"sort bit-identical at capacities {2 * full} and {full // 2}, "
              f"align-copy "
              f"bit-identical, "
              f"compositor max abs err {err:.3g}, n_contrib/k_last equal "
              f"{m_nc:.6f}/{m_kl:.6f}", flush=True)


NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def check_backward_kernels(k4_args, k5_args, errs, where: str):
    """The backward compositor and the segment sum on the inputs a backward
    gave them, against their plain versions: bit-identical."""
    import torch

    from tpugs_torch.ops import composite_t, pack, segreduce

    with torch.no_grad():
        got = composite_t.composite_backward(*k4_args)
        ref = composite_t.composite_backward_plain(*k4_args)
        valid = k4_args[3][pack.VALID_ROW] > 0
        check(bool(torch.isfinite(got[:, valid]).all()),
              "backward compositor output not finite")
        err4 = float((got[:, valid] - ref[:, valid]).abs().max())
        got = segreduce.segment_sum_sorted(*k5_args)
        err5 = float((got - segreduce.segment_sum_sorted_plain(
            *k5_args)).abs().max())
    check(err4 == 0.0, f"backward compositor differs from its plain version "
          f"by {err4} ({where})")
    check(err5 == 0.0, f"segment sum differs from its plain version by "
          f"{err5} ({where})")
    errs["composite_bwd"] = max(errs.get("composite_bwd", 0.0), err4)
    errs["segreduce"] = max(errs.get("segreduce", 0.0), err5)


def phase_grad_kernels(dev, errs):
    """The 20k scene rendered with gradients on the card and on the CPU;
    the backward kernels held against their plain versions on the inputs
    the card's backward gave them."""
    import numpy as np
    import torch

    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops import composite_t, segreduce
    from tpugs_torch.ops.render import RasterConfig, render
    from tpugs_torch.train.loss import combined_loss
    from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                             synthetic_params_numpy)

    w, h, n = 256, 192, 20_000
    p = synthetic_params_numpy(n, seed=0)
    target = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    intr = synthetic_intrinsics_numpy(w, h)
    cpu = torch.device("cpu")
    for tile in (16, 32):
        cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=SMALL_PAIR_CAPACITY,
                           max_hits_per_tile=1 << 20)
        grads = {}
        for d in (dev, cpu):
            tp = {k: v.requires_grad_(True)
                  for k, v in params_from_numpy(p, d).items()}
            with capturing(composite_t, "composite_backward") as k4, \
                    capturing(segreduce, "segment_sum_sorted") as k5:
                out = render(*[tp[k] for k in NAMES],
                             torch.ones(n, dtype=torch.bool, device=d),
                             torch.eye(4, device=d),
                             torch.from_numpy(intr).to(d), cfg, 3,
                             torch.zeros(3, device=d))
                loss = combined_loss(out.color, torch.from_numpy(target).to(d))
                grads[d.type] = torch.autograd.grad(loss, [tp[k] for k in NAMES])
            if d.type == "cuda":
                check_backward_kernels(k4[0], k5[0], errs, f"tile {tile}")
        shares = {}
        for name, a, b in zip(NAMES, grads["cuda"], grads["cpu"]):
            check(bool(torch.isfinite(a).all()), f"d {name} not finite")
            shares[name] = close_share(a.cpu(), b)
            check(shares[name] >= MIN_GRAD_MATCH,
                  f"d {name}: {shares[name]} of elements within tolerance "
                  f"of the CPU's (< {MIN_GRAD_MATCH})")
        print(f"tile {tile} gradients: {int(out.num_pairs)} pairs; backward "
              f"compositor and segment sum bit-identical to their plain "
              f"versions; card vs CPU gradients within tolerance on "
              f"{min(shares.values()):.6f} of elements (worst group)",
              flush=True)


def cli_scene(tmp):
    """The render CLI's scene: CLI_N seeded gaussians of SH degree 3 as a
    PLY under tmp -> (params, path)."""
    from tpugs_torch.io.ply import write_gaussian_ply_numpy
    from tpugs_torch.utils.synthetic import synthetic_params_numpy

    p = synthetic_params_numpy(CLI_N, seed=0, scale_range=(0.002, 0.015))
    ply = os.path.join(tmp, "scene_1m_sh3.ply")
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    return p, ply


def cli_argv(ply, frames_dir, frames: int, device: str = "cuda"):
    """The render CLI's arguments at full width."""
    return ["-m", ply, "-o", frames_dir, "--frames", str(frames),
            "--width", str(CLI_W), "--height", str(CLI_H),
            "--pair-capacity", str(CLI_PAIR_CAPACITY),
            "--max-hits", str(CLI_MAX_HITS), "--on-overflow", "error",
            "--device", device]


def phase_cli(tmp, dev):
    """The render CLI at full width; returns the per-frame lines and launch
    counts of its run."""
    import numpy as np
    from PIL import Image

    from tpugs_torch.apps import render as render_app

    p, ply = cli_scene(tmp)
    frames = os.path.join(tmp, "frames")
    argv = cli_argv(ply, frames, CLI_FRAMES, dev.type)
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = render_app.main(argv)
    launches = read_launches()
    check(rc == 0, f"render CLI returned {rc}")
    stats = re.findall(r"frame (\d+): \S+ pairs (\d+) max_tile_hits (\d+) "
                       r"ms ([\d.]+)", out.getvalue())
    check(len(stats) == CLI_FRAMES, f"CLI printed {len(stats)} frame lines")
    for i, pairs, hits, ms in stats:
        tag = "warm-up" if int(i) == 0 else "steady"
        print(f"cli frame {i} ({tag}): {pairs} pairs, busiest tile {hits}, "
              f"{float(ms):.3f} ms", flush=True)
    steady = [float(s[3]) for s in stats[1:]]
    print(f"cli 1920x1080 1M SH3: {np.mean(steady):.3f} ms/frame after "
          f"warm-up; launches {launches}", flush=True)
    check_launches(launches, ("expand", "align_copy", "composite_fwd"),
                   CLI_FRAMES, "frames")
    for i in range(CLI_FRAMES):
        img = np.asarray(Image.open(os.path.join(frames, f"frame_{i:04d}.png")))
        check(img.shape == (CLI_H, CLI_W, 3), f"frame {i} shape {img.shape}")
        check(img.max() > 0, f"frame {i} is black")
    return p, launches, stats


def phase_timing(dev, params, errs):
    """The render CLI's frame 0 rebuilt, and its forward kernels' rows."""
    import torch

    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops import expand, pack
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.rasterize_tiled import RasterConfig
    from tpugs_torch.viewer.camera import orbit_trajectory

    tile = 32
    cfg = RasterConfig(img_h=CLI_H, img_w=CLI_W, tile_h=tile, tile_w=tile,
                       pair_capacity=CLI_PAIR_CAPACITY,
                       max_hits_per_tile=CLI_MAX_HITS)
    cam = orbit_trajectory(params["means"], CLI_FRAMES, CLI_W, CLI_H)[0]
    p = params_from_numpy(params, dev)
    n = p["means"].shape[0]
    proj = project_gaussians(
        p["means"], p["quats"], p["log_scales"], p["opacity_logits"], p["sh"],
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.as_tensor(cam.world_to_camera(), dtype=torch.float32, device=dev),
        torch.as_tensor(cam.intrinsics_array(), device=dev), CLI_W, CLI_H, 3)
    # The CLI's presort="fastest" takes the qkey sort at N = 1M.
    ex = B.expand_inputs(proj, CLI_W, CLI_H, tile, tile, cfg.pair_capacity,
                         quant_key_bits=32)
    a1 = (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile)
    b = B.sort_pairs(*expand.expand_pairs(*a1), ex.num_tiles, n, ex.total,
                     cfg.pair_capacity, qbits=ex.qbits)
    b, _ = B.clamp_tile_segments(b, cfg.max_hits_per_tile)
    astart, astop, counts = pack.aligned_offsets(b.tile_start, b.tile_stop)
    pal = pack.aligned_length(astart, counts)
    attr_c = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                     proj.rgb, proj.opac, b.pair_gauss.shape[0])
    a2 = (attr_c, b.tile_start, astart, counts, pal)
    a3 = (cfg, astart, astop, pack.align_copy(*a2), 0)
    return forward_kernel_rows(dev, a1, a2, a3, errs, "render frame")


def in_image(cfg, dev):
    """[T, PIX] bool: the tile pixels that lie inside the image."""
    import torch

    p = torch.arange(cfg.pix, device=dev)
    t = torch.arange(cfg.num_tiles, device=dev)[:, None]
    x = (t % cfg.ntx) * cfg.tile_w + p % cfg.tile_w
    y = (t // cfg.ntx) * cfg.tile_h + p // cfg.tile_w
    return (x < cfg.img_w) & (y < cfg.img_h)


def _walk_line(walk) -> str:
    """max, 99th percentile and mean of per-tile walks, and their count."""
    import torch

    w = torch.sort(walk.flatten()).values
    p99 = int(w[int(0.99 * (w.shape[0] - 1))]) if w.shape[0] else 0
    return (f"max {int(w.max()) if w.shape[0] else 0} p99 {p99} mean "
            f"{float(w.float().mean()) if w.shape[0] else 0.0:.1f} over "
            f"{w.shape[0]} tiles")


def _by_kernel_slot(cfg, per_pixel, pad, backward: bool):
    """[T, PIX] -> [T, G, warps, WARP * ppt] in the forward's or the
    backward's pixel order (composite_t.kernel_pixels), `pad` where a slot
    lies past the tile."""
    import torch

    from tpugs_torch.ops import composite_t

    kp = composite_t.kernel_pixels(cfg.tile_w, cfg.tile_h, backward,
                                   per_pixel.device)
    flat = kp.flatten()
    out = per_pixel[:, flat.clamp(min=0)]
    out = torch.where(flat[None, :] >= 0, out, torch.full_like(out, pad))
    return out.reshape(per_pixel.shape[0], kp.shape[0], kp.shape[1], -1)


def _ceil(x, m):
    return (x + m - 1) // m * m


def step1_forward(cfg, a3, got, alone_ms, where: str):
    """Step 1's split of the forward compositor on one frame: the busiest
    tile alone (every other tile's segment emptied), the (pixel, entry)
    pairs that one block per tile, sub-tile blocks and 8x4 warps evaluate
    against those that are needed, and the distribution of tile walks."""
    import torch

    from tpugs_torch.ops import composite_t
    from tpugs_torch.ops.rasterize_tiled import T_THRESHOLD

    _, astart, astop, attr, row_offset = a3
    num = (astop - astart).long()
    busiest = int(torch.argmax(num))
    only = astart.clone()
    only[busiest] = astop[busiest]
    busy_ms = timed_alone(lambda: composite_t.composite_forward(
        cfg, astart, only, attr, row_offset))
    _, final_t, _, k_last = got
    # A pixel walks until T drops below the threshold (k_last + 1 entries),
    # else its tile's every entry.
    walk = torch.where(final_t < T_THRESHOLD, k_last.long() + 1,
                       num[:, None].expand_as(k_last))
    batch = 256
    tile_walk = torch.minimum(num, _ceil(walk.max(1).values, batch))
    by_slot = _by_kernel_slot(cfg, walk, 0, False)
    per_warp = by_slot.shape[-1]
    sub_walk = torch.minimum(num[:, None], _ceil(by_slot.amax((2, 3)), batch))
    warp_walk = torch.minimum(sub_walk[:, :, None], _ceil(by_slot.amax(3), 8))
    needed = int((walk * in_image(cfg, walk.device)).sum())
    tile_ev = cfg.pix * int(tile_walk.sum())
    sub_ev = per_warp * by_slot.shape[2] * int(sub_walk.sum())
    warp_ev = per_warp * int(warp_walk.sum())
    print(f"step1 K3 {where}: whole kernel alone {alone_ms:.4f} ms, busiest "
          f"tile ({int(num[busiest])} entries) alone {busy_ms:.4f} ms; "
          f"(pixel, entry) pairs evaluated: one block per tile {tile_ev} "
          f"({tile_ev / needed:.2f}x needed), {sub_walk.shape[1]} sub-tile "
          f"blocks per tile {sub_ev} ({sub_ev / needed:.2f}x), their 8x4 "
          f"warps at an 8-entry vote {warp_ev} ({warp_ev / needed:.2f}x), "
          f"needed "
          f"{needed}; tile walks {_walk_line(tile_walk)}, busiest tile's "
          f"walk {int(tile_walk[busiest])}", flush=True)


def step1_backward(a4, alone_ms, where: str, **kw):
    """Step 1's split of the backward compositor (K4, or K4b with
    transposed_out=False in kw): the busiest tile alone, the (pixel, entry)
    pairs evaluated from the tile's largest k_last down, by the tile and by
    warps from their own largest k_last, against those needed, and the
    distribution of tile walks."""
    import torch

    from tpugs_torch.ops import composite_t

    cfg, astart, astop, k_last = a4[0], a4[1], a4[2], a4[7]
    num = (astop - astart).long()
    busiest = int(torch.argmax(num))
    only = astart.clone()
    only[busiest] = astop[busiest]
    args = (a4[0], astart, only) + tuple(a4[3:])
    busy_ms = timed_alone(lambda: composite_t.composite_backward(*args, **kw))
    kl = k_last.long()
    tile_walk = (torch.minimum(kl.max(1).values, num - 1) + 1).clamp(min=0)
    by_slot = _by_kernel_slot(cfg, kl, -1, True)
    warp_walk = (torch.minimum(by_slot.amax(3), num[:, None, None] - 1)
                 + 1).clamp(min=0)
    needed = int(((kl + 1) * in_image(cfg, kl.device)).sum())
    tile_ev = cfg.pix * int(tile_walk.sum())
    warp_ev = by_slot.shape[-1] * int(warp_walk.sum())
    name = "K4b" if kw.get("transposed_out") is False else "K4"
    print(f"step1 {name} {where}: whole kernel alone {alone_ms:.4f} ms, "
          f"busiest tile ({int(num[busiest])} entries) alone {busy_ms:.4f} "
          f"ms; (pixel, entry) pairs evaluated: from the tile's largest "
          f"k_last {tile_ev} ({tile_ev / needed:.2f}x needed), 8x8 warps "
          f"of {by_slot.shape[1]} sub-tiles from their own {warp_ev} "
          f"({warp_ev / needed:.2f}x), needed {needed}; tile walks "
          f"{_walk_line(tile_walk)}, busiest tile's walk "
          f"{int(tile_walk[busiest])}", flush=True)


# csrc/expand.cu's chunk of consecutive gaussians per block, per mode.
EXPAND_CHUNK = {"expand": 512, "expand_carry": 256}


def expand_slots(itab, p_out: int):
    """Each gaussian's slots below p_out (int64 [N]); a gaussian owns a
    slot where this is > 0."""
    import torch

    off, cnt = itab[0].long(), itab[1].long()
    return (torch.clamp(off + cnt, max=p_out) - off).clamp(min=0)


def owned_slots(itab, p_out: int) -> int:
    """The slots some gaussian owns, those the kernel writes: min(total,
    p_out). The static p_out's other slots keep the wrapper's sentinel
    fill."""
    return int(expand_slots(itab, p_out).sum())


def expand_bytes(itab, p_out: int, carry: bool) -> int:
    """The least bytes of K1 (carry: K1b): each gaussian's count, the other
    eight table words of each gaussian that owns a slot below p_out, and
    12 bytes written per owned slot; carry mode adds 36 bytes per owning
    gaussian and 36 per owned slot."""
    owners = int((expand_slots(itab, p_out) > 0).sum())
    per_owner, per_slot = (68, 48) if carry else (32, 12)
    return (4 * itab.shape[1] + per_owner * owners
            + per_slot * owned_slots(itab, p_out))


def step1_expand(itab, p_out: int, alone_ms: float, name: str, where: str):
    """Step 1's split of the expand kernel on one frame's inputs: the
    gaussians that own no slot below p_out, the slots per owning gaussian,
    the lane use of a warp-per-gaussian slot loop (slots / (32 x its
    iterations)) and the slot spans of csrc/expand.cu's chunks."""
    import torch

    slots = expand_slots(itab, p_out)
    n = itab.shape[1]
    zero = int((itab[1] <= 0).sum())
    owners = int((slots > 0).sum())
    owned = int(slots.sum())
    iters = int(((slots + 31) // 32).sum())
    c = EXPAND_CHUNK[name]
    span = torch.nn.functional.pad(slots, (0, -n % c)).view(-1, c).sum(1)
    busy = span[span > 0]
    print(f"step1 {'K1b' if name == 'expand_carry' else 'K1'} {where}: "
          f"alone {alone_ms:.4f} ms; {n} gaussians, {zero / n:.6f} with "
          f"count 0 and {(n - zero - owners) / n:.6f} more with offset >= "
          f"p_out ({owners} own a slot); {owned} owned slots of {p_out}, per "
          f"owning gaussian mean {owned / max(owners, 1):.3f} max "
          f"{int(slots.max())}; a warp per gaussian: {iters} slot-loop "
          f"iterations, lane use {owned / max(32 * iters, 1):.4f}; chunks of "
          f"{c}: {span.shape[0]}, "
          f"{busy.shape[0]} own a slot, span max {int(span.max())} mean "
          f"{float(busy.float().mean()) if busy.shape[0] else 0.0:.1f} "
          f"(over those)", flush=True)


def forward_kernel_rows(dev, a1, a2, a3, errs, where: str):
    """The three forward kernels on one frame's inputs (a1 for expand, a2
    for align-copy, a3 for the compositor): each held against its plain
    version (expand and align-copy bit-identical, the compositor on the
    whole frame and on 8 tiles incl. the busiest), timed alone beside its
    plain version and (align-copy) a library call. Returns their rows."""
    import numpy as np
    import torch

    from tpugs_torch.ops import composite_t, expand, pack
    from tpugs_torch.ops.rasterize_tiled import T_THRESHOLD

    kern = without_sync(lambda: expand.expand_pairs(*a1), "expand_pairs")
    check(all(torch.equal(a, b) for a, b in
              zip(kern, expand.expand_pairs_plain(*a1))),
          f"expand differs from its plain version on the {where}")
    errs.setdefault("expand", 0.0)
    itab, p_out = a1[0], a1[2]
    k_ms = cuda_ms(lambda: expand.expand_pairs(*a1))
    alone_ms = timed_alone(lambda: expand.expand_pairs(*a1))
    pl_ms = cuda_ms(lambda: expand.expand_pairs_plain(*a1), reps=3)
    k1_ops = owned_slots(itab, p_out) * 16  # index math, clamp, cull per slot
    rows = [Row("expand", k_ms, alone_ms, pl_ms,
                expand_bytes(itab, p_out, False), k1_ops,
                extra={"host_ms": host_ms(lambda: expand.expand_pairs(*a1))})]
    step1_expand(itab, p_out, alone_ms, "expand", where)

    attr_c, tile_start, astart, counts, pal = a2
    attr = without_sync(lambda: pack.align_copy(*a2), "align_copy")
    check(torch.equal(attr, pack.align_copy_plain(*a2)),
          f"align-copy differs from its plain version on the {where}")
    errs.setdefault("align_copy", 0.0)
    k_ms = cuda_ms(lambda: pack.align_copy(*a2))
    alone_ms = timed_alone(lambda: pack.align_copy(*a2))
    pl_ms = cuda_ms(lambda: pack.align_copy_plain(*a2), reps=3)
    # Library yardstick: one index_select of the same columns, gaps pointing
    # at an appended zero column.
    j = torch.arange(pal, device=dev)
    owner = torch.searchsorted(astart.long(), j, right=True) - 1
    k = j - astart.long()[owner]
    src = torch.where(k < counts.long()[owner], tile_start.long()[owner] + k,
                      torch.full_like(k, attr_c.shape[1]))
    attr_z = torch.cat([attr_c, torch.zeros_like(attr_c[:, :1])], 1)
    check(torch.equal(attr_z.index_select(1, src), attr), "index_select yardstick")
    lib_ms = cuda_ms(lambda: attr_z.index_select(1, src))
    entries = int(counts.sum())
    rows.append(Row("align_copy", k_ms, alone_ms, pl_ms,
                    entries * 64 + pal * 64, 0, lib_ms, "index_select"))

    cfg = a3[0]
    got = without_sync(lambda: composite_t.composite_forward(*a3),
                       "composite_forward")
    k_ms = cuda_ms(lambda: composite_t.composite_forward(*a3))
    alone_ms = timed_alone(lambda: composite_t.composite_forward(*a3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = composite_t.composite_forward_plain(*a3)
    torch.cuda.synchronize()
    pl_ms = (time.perf_counter() - t0) * 1e3
    err, m_nc, m_kl = compare_compositor(got, ref)
    # 8 tiles from the seed, the busiest among them, also on their own.
    busiest = int(torch.argmax(counts))
    rng = np.random.default_rng(0)
    pick = [busiest] + [int(t) for t in rng.choice(cfg.num_tiles, 7, replace=False)]
    sel = torch.tensor(pick, device=dev)
    sub = composite_t.composite_forward_plain(*a3, tiles=sel)
    err8, _, _ = compare_compositor(tuple(g[sel] for g in got), sub)
    errs["composite_fwd"] = max(errs.get("composite_fwd", 0.0), err, err8)
    # Work this frame needs: a pixel inside the image walks its tile's
    # entries until T drops below the threshold (then k_last + 1 of them),
    # else all of them.
    _, final_t, n_contrib, k_last = got
    inside = in_image(cfg, dev)
    num = counts.long()[:, None].expand_as(k_last)
    walked = torch.where(final_t < T_THRESHOLD, k_last.long() + 1, num)
    pairs_eval = int((walked * inside).sum())
    # 17 f32 operations per evaluated (pixel, entry), exp counted as one,
    # and 9 more per contribution.
    k3_ops = 17 * pairs_eval + 9 * int((n_contrib * inside).sum())
    k3_bytes = entries * 36 + cfg.num_tiles * cfg.pix * 24
    rows.append(Row("composite_fwd", k_ms, alone_ms, pl_ms, k3_bytes, k3_ops))
    step1_forward(cfg, a3, got, alone_ms, where)
    print(f"{where}: {p_out} expand slots, {entries} composited entries in "
          f"{counts.shape[0]} tiles (per tile: max {int(counts.max())}, mean "
          f"{entries / counts.shape[0]:.1f}), "
          f"{pal} aligned columns; expand and align-copy bit-identical to "
          f"their plain versions; compositor max abs err {err:.3g} "
          f"(n_contrib/k_last equal {m_nc:.6f}/{m_kl:.6f}), on 8 tiles incl. "
          f"the busiest ({int(counts[busiest])} entries) {err8:.3g}", flush=True)
    return rows


def phase_train_step(dev, errs):
    """The port's train step (tpugs_torch.train.trainer.make_train_step) at
    the garden shape; returns the five kernels' rows (each timed and held
    against its plain version on step 0's inputs), the launches of the run
    and ms per step."""
    import numpy as np
    import torch

    from tpugs_torch.ops import composite_t, expand, pack, segreduce
    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import (TrainConfig, TrainState,
                                           initial_key, make_train_step)
    from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                             synthetic_params)

    check(torch.get_float32_matmul_precision() == "highest"
          and torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmuls would run in TF32")
    w, h, n = TRAIN_W, TRAIN_H, TRAIN_N
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=32, tile_w=32,
                       pair_capacity=TRAIN_PAIR_CAPACITY,
                       max_hits_per_tile=TRAIN_MAX_HITS)
    params = synthetic_params(n, seed=0, device=dev, scale_range=(0.002, 0.015))
    state = TrainState(params=params,
                       alive=torch.ones(n, dtype=torch.bool, device=dev),
                       adam=adam_init(params), adc=adc_init(n, dev),
                       key=initial_key(0))
    train_step = make_train_step(TrainConfig(densify_mode="none"), cfg, 1.0)
    viewmat = torch.eye(4, device=dev)
    intr = torch.from_numpy(synthetic_intrinsics_numpy(w, h)).to(dev)
    target = torch.rand((h, w, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms, losses = [], []
    torch.cuda.synchronize()
    reset_launches()
    with capturing(expand, "expand_pairs") as k1, \
            capturing(pack, "align_copy") as k2, \
            capturing(composite_t, "composite_forward") as k3, \
            capturing(composite_t, "composite_backward") as k4, \
            capturing(segreduce, "segment_sum_sorted") as k5, \
            capturing(segreduce, "sort_by_key") as srt:
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            ev0.record()
            state, stats = train_step(state, target, viewmat, intr,
                                      torch.tensor(float(i)), 3)
            ev1.record()
            torch.cuda.synchronize()
            ms.append(ev0.elapsed_time(ev1))
            losses.append(float(stats.loss))
            check(not bool(stats.pair_overflow) and not bool(stats.hit_overflow),
                  f"step {i} overflowed: {int(stats.num_pairs)} pairs, "
                  f"busiest tile {int(stats.max_tile_hits)}")
            check(np.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}")
            # A non-finite gradient would make Adam's first moment so.
            check(all(bool(torch.isfinite(m).all())
                      for m in state.adam.m.values()),
                  f"step {i}: gradients not finite")
            if i == 0:
                pairs0, hits0 = int(stats.num_pairs), int(stats.max_tile_hits)
    launches = read_launches()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    check_launches(launches, SORTED_PATH, steps, "train steps")
    step_ms = float(np.mean(ms[TRAIN_WARMUP:]))
    print(f"train step {w}x{h} 1M SH3: {step_ms:.3f} ms/step "
          f"(steps {', '.join(f'{m:.1f}' for m in ms)} ms), "
          f"{w * h / (step_ms * 1e-3) / 1e6:.4f} Mpix/s; step 0: {pairs0} "
          f"pairs, busiest tile {hits0}; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches {launches}", flush=True)

    del state
    with torch.no_grad():
        rows = forward_kernel_rows(dev, k1[0], k2[0], k3[0], errs,
                                   "train frame")
        rows += backward_kernel_rows(dev, k4[0], k5[0], srt[0], errs)
    return rows, launches, step_ms


def backward_kernel_rows(dev, a4, a5, sort_args, errs, where="train frame"):
    """K4 and K5 timed alone on the inputs a train step gave them, beside
    their plain versions, their bounds and (K5) index_add_; the gid sort
    timed on its own inputs. Returns their kernel rows."""
    import numpy as np
    import torch

    from tpugs_torch.ops import composite_t, pack, segreduce

    check_backward_kernels(a4, a5, errs, where)
    cfg, astart, astop, k_last = a4[0], a4[1], a4[2], a4[7]
    got = without_sync(lambda: composite_t.composite_backward(*a4),
                       "composite_backward")
    k_ms = cuda_ms(lambda: composite_t.composite_backward(*a4))
    alone_ms = timed_alone(lambda: composite_t.composite_backward(*a4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    composite_t.composite_backward_plain(*a4)
    torch.cuda.synchronize()
    pl_ms = (time.perf_counter() - t0) * 1e3
    counts = (astop - astart).long()
    busiest = int(torch.argmax(counts))
    rng = np.random.default_rng(0)
    pick = [busiest] + [int(t) for t in rng.choice(cfg.num_tiles, 7, replace=False)]
    sub = composite_t.composite_backward_plain(
        *a4, tiles=torch.tensor(pick, device=dev))
    cols = torch.cat([torch.arange(int(astart[t]), int(astop[t]), device=dev)
                      for t in pick])
    err8 = float((got[:, cols] - sub[:, cols]).abs().max())
    check(err8 == 0.0, f"backward compositor differs from its plain version "
          f"on 8 tiles of the {where} by {err8}")
    entries = int(counts.sum())
    # The (pixel, entry) pairs the gradient needs: each pixel inside the
    # image, down from its last contributor (pixels past the image's edge
    # get no colour cotangent).
    walked = int(((k_last.long() + 1) * in_image(cfg, dev)).sum())
    # 53 f32 operations per such pair (exp counted as one; comparisons and
    # selects not counted), as csrc/composite_bwd.cu counts them.
    k4_ops = 53 * walked
    k4_bytes = 2 * entries * 36 + cfg.num_tiles * cfg.pix * 24
    rows = [Row("composite_bwd", k_ms, alone_ms, pl_ms, k4_bytes, k4_ops)]
    step1_backward(a4, alone_ms, where)
    print(f"backward compositor on the {where}: {entries} entries, "
          f"{walked} in-image (pixel, entry) pairs to the last contributor; "
          f"bit-identical to its plain version (also on 8 tiles incl. the "
          f"busiest, {int(counts[busiest])} entries)", flush=True)

    # K5 alone, its plain version, the gid sort before it, and the library
    # yardstick: one index_add_ of the same masked (unsorted) columns.
    key, mcols, n_red = sort_args
    got = segreduce.segment_sum_sorted(*a5)
    k_ms = cuda_ms(lambda: segreduce.segment_sum_sorted(*a5))
    alone_ms = timed_alone(lambda: segreduce.segment_sum_sorted(*a5))
    pl_ms = cuda_ms(lambda: segreduce.segment_sum_sorted_plain(*a5), reps=3)
    sort_ms = cuda_ms(lambda: segreduce.sort_by_key(key, mcols, n_red))
    idx = torch.clamp(key, max=n_red).long()
    acc = torch.zeros((pack.NUM_ATTR, n_red + 1), device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(1, idx, mcols))
    lib = torch.zeros_like(acc).index_add_(1, idx, mcols)[:, :n_red]
    lib_err = float((lib - got).abs().max())
    check(lib_err <= 1e-4 * float(got.abs().max()),
          f"index_add_ yardstick differs from the segment sum by {lib_err}")
    valid_slots = int(a5[1][-1])
    k5_bytes = 10 * valid_slots * 4 + pack.NUM_ATTR * n_red * 4
    rows.append(Row("segreduce", k_ms, alone_ms, pl_ms, k5_bytes,
                    valid_slots * pack.NUM_ATTR, lib_ms,
                    "index_add_ (output zeroed outside the time)"))
    print(f"segment sum: {valid_slots} valid slots of {key.shape[0]} into "
          f"{n_red} gaussians, bit-identical to its plain version; gid sort "
          f"(torch.sort + column gather) {sort_ms:.4f} ms; index_add_ "
          f"{lib_ms:.4f} ms (max abs diff {lib_err:.3g})", flush=True)
    return rows


BENCH_CPU_STEPS = 2  # the 50k bench's first steps, on the card and the CPU
CARRY_PATH = ("expand_carry",) + SORTED_PATH[1:]


@contextlib.contextmanager
def bench_step_launches():
    """While the block runs, tpugs_torch.bench's overflow check (the render
    measure_config makes after its steps) first records the launches so
    far, those of the steps alone, and then its own output."""
    from tpugs_torch import bench

    orig = bench.assert_no_overflow
    seen = []

    def check_frame(*args):
        launches = read_launches()
        seen.append((launches, orig(*args)))
        return seen[-1][1]

    bench.assert_no_overflow = check_frame
    try:
        yield seen
    finally:
        bench.assert_no_overflow = orig


def bench_measure(dev, shape: dict, carry: bool, what: str, path):
    """tpugs_torch.bench.measure_config at one of bench.py's shapes: every
    step launches each kernel of `path` once and nothing else, the losses
    and the rate are finite. Returns (its Measured, the steps' launches)."""
    import numpy as np
    import torch

    from tpugs_torch import bench
    from tpugs_torch.train import graph

    k, rounds = shape["k"], shape["rounds"]
    steps = (rounds + 1) * k
    torch.cuda.synchronize()
    reset_launches()
    with bench_step_launches() as seen:
        m = bench.measure_config(**shape, device=dev, carry=carry)
    check(m.captures == 1 and m.replays == steps - graph.WARMUP_STEPS,
          f"{what} bench: {m.captures} captures, {m.replays} replays of "
          f"{steps} steps")
    launches = executed(seen[0][0], path, m.captures, m.replays)
    check_launches(launches, path, steps, f"{what} bench steps")
    check(m.losses.shape == (steps,) and bool(np.isfinite(m.losses).all()),
          f"{what} bench losses {m.losses}")
    check(math.isfinite(m.mpix_s) and m.mpix_s > 0,
          f"{what} bench: {m.mpix_s} Mpix/s")
    print(f"bench {what} {shape['img_w']}x{shape['img_h']}, {shape['n']} "
          f"gaussians{', carry on' if carry else ''}: {m.its:.4f} it/s, "
          f"{m.mpix_s:.4f} Mpix/s ({1e3 / m.its:.3f} ms/step; {rounds} x "
          f"{k} steps in {m.seconds:.4f} s); at the final params "
          f"{m.num_pairs} pairs of capacity {shape['pair_capacity']} "
          f"({m.num_pairs / shape['pair_capacity']:.4f}), busiest tile "
          f"{m.max_tile_hits} of max hits {shape['max_hits']}; loss "
          f"{m.losses[0]:.6f} -> {m.losses[-1]:.6f}; {m.replays} of the "
          f"steps graph replays, the capture {m.capture_seconds:.3f} s",
          flush=True)
    return m, launches


def bench_50k_step(device, carry: bool = False):
    """The 50k bench's step (tpugs_torch.bench.make_bench_step) on one
    device, with its scene's parameters and a fresh Adam state."""
    from tpugs_torch import bench
    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init

    s = bench.PRIMARY
    w, h = s["img_w"], s["img_h"]
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=bench.TILE, tile_w=bench.TILE,
                       pair_capacity=s["pair_capacity"],
                       max_hits_per_tile=s["max_hits"])
    params, alive, vm, intr, bg = bench.bench_scene(w, h, s["n"], None, device)
    step = bench.make_bench_step(cfg, alive, vm, intr, bg,
                                 bench.bench_target(w, h, device), carry)
    return step, params, adam_init(params)


def bench_busy_share(dev):
    """One timed 50k round (k steps and the host read of the last loss)
    under torch.profiler, after a warm-up round: the device's busy share of
    the round's wall time, the kernels and copies per step, and the host
    syncs of one step. Printed, not gated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpugs_torch import bench

    k = bench.PRIMARY["k"]
    step, params, adam = bench_50k_step(dev)
    params, adam, losses = bench.run_k(step, params, adam, 0.0, k)
    float(losses[-1])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        params, adam, losses = bench.run_k(step, params, adam, float(k), k)
        float(losses[-1])
        wall_ms = (time.perf_counter() - h0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in dev_events) / 1e3
    launches = sum(e.count for e in dev_events) / k
    top = sorted(dev_events, key=lambda e: getattr(e, attr), reverse=True)[:5]
    step_t = torch.tensor(float(2 * k), device=dev)  # its copy: not the step's
    syncs = sync_warnings(lambda: step(params, adam, step_t))
    if busy_ms == 0:
        print("bench 50k round: torch.profiler recorded no device time, so "
              "its busy share is not measured", flush=True)
    print(f"bench 50k round under torch.profiler: wall {wall_ms:.3f} ms for "
          f"{k} steps, device busy {busy_ms:.3f} ms, busy share "
          f"{busy_ms / wall_ms:.4f}, idle share {1 - busy_ms / wall_ms:.4f}; "
          f"{launches:.1f} kernels and copies per step; top: "
          + ", ".join(f"{e.key[:40]} {getattr(e, attr) / 1e3 / k:.4f} ms"
                      for e in top)
          + f"; host syncs in one step: {len(syncs)} "
          f"({collections.Counter(syncs).most_common()})", flush=True)


def phase_bench(dev, errs):
    """tpugs_torch.bench (bench_torch.py) on the card: (a) bench.py's two
    shapes, carry off, K1-K5 once per step; (b) K1-K5 held against their
    plain versions on the 50k bench's step-0 inputs; (c) the 50k shape
    with carry on, K1b in K1's place and the losses equal to (a)'s; (d) the
    50k bench's first steps on the card against the CPU, by the Trainer's
    parity rules; and the device's busy share over one timed 50k round.
    Returns (the rows of (b) and (c), the launches of the three runs)."""
    import numpy as np
    import torch

    from tpugs_torch import bench
    from tpugs_torch.ops import composite_t, expand, pack, segreduce
    from tpugs_torch.optim.adam import AdamConfig, group_lrs

    m50, l50 = bench_measure(dev, bench.PRIMARY, False, "50k", SORTED_PATH)
    mg, lg = bench_measure(dev, bench.GARDEN, False, "garden", SORTED_PATH)
    print("bench_torch.py line: " + json.dumps(bench.result_line(m50, mg)),
          flush=True)

    with capturing(expand, "expand_pairs", carry_mode) as k1b:
        mc, lc = bench_measure(dev, bench.PRIMARY, True, "50k", CARRY_PATH)
    diff = float(np.abs(mc.losses - m50.losses).max())
    check(np.array_equal(mc.losses, m50.losses),
          f"carried bench losses differ from carry off by up to {diff}")
    with torch.no_grad():
        rows = [expand_carry_row(dev, k1b[0], errs, "bench 50k carried frame")]
    print(f"bench 50k carry on: the {mc.losses.shape[0]} losses equal carry "
          f"off's; K1b once per step in K1's place, bit-identical to its "
          f"plain version on step 0's inputs", flush=True)

    with capturing(expand, "expand_pairs") as k1, \
            capturing(pack, "align_copy") as k2, \
            capturing(composite_t, "composite_forward") as k3, \
            capturing(composite_t, "composite_backward") as k4, \
            capturing(segreduce, "segment_sum_sorted") as k5, \
            capturing(segreduce, "sort_by_key") as srt:
        p_card, _, l_card = bench.run_k(*bench_50k_step(dev), 0.0,
                                        BENCH_CPU_STEPS)
    t0 = time.perf_counter()
    p_cpu, _, l_cpu = bench.run_k(*bench_50k_step(torch.device("cpu")), 0.0,
                                  BENCH_CPU_STEPS)
    cpu_s = time.perf_counter() - t0
    l_card, l_cpu = l_card.cpu().numpy(), l_cpu.numpy()
    check(np.array_equal(l_card, m50.losses[:BENCH_CPU_STEPS]),
          f"the bench's first steps again: losses {l_card} against "
          f"{m50.losses[:BENCH_CPU_STEPS]}")
    check(np.allclose(l_card, l_cpu, rtol=1e-4, atol=0),
          f"bench losses card {l_card} against CPU {l_cpu}")
    lrs = {k: float(v) for k, v in group_lrs(AdamConfig(), 0.0).items()}
    close = {}
    for name in NAMES:
        a, b = p_card[name].cpu(), p_cpu[name]
        check(bool(torch.isfinite(a).all()), f"bench {name} not finite")
        tol = BENCH_CPU_STEPS * 2 * lrs[name] + 1e-6
        close[name] = float(((a - b).abs() <= tol).float().mean())
    check(min(close.values()) >= MIN_GRAD_MATCH,
          f"bench params card against CPU: within steps x 2 x lr on only "
          f"{close}")
    print(f"bench 50k first {BENCH_CPU_STEPS} steps, card against CPU: "
          f"losses {l_card.tolist()} / {l_cpu.tolist()} (max rel diff "
          f"{float(np.max(np.abs(l_card - l_cpu) / np.abs(l_cpu))):.3g}), "
          f"params within steps x 2 x lr on {min(close.values()):.6f} of "
          f"elements (worst group); the CPU's steps took {cpu_s:.1f} s",
          flush=True)
    del p_card, p_cpu
    with torch.no_grad():
        rows += forward_kernel_rows(dev, k1[0], k2[0], k3[0], errs,
                                    "bench 50k frame")
        rows += backward_kernel_rows(dev, k4[0], k5[0], srt[0], errs,
                                     "bench 50k frame")
    bench_busy_share(dev)
    return rows, {"bench_50k_steps": l50, "bench_garden_steps": lg,
                  "bench_50k_carry_steps": lc}


GRAPH_K = 6  # steps of each graphed block in phase graph


def clone_state(state):
    """A TrainState with copies of every tensor (a graphed multi-step's
    state is its buffers, which its next block overwrites)."""
    import dataclasses

    from tpugs_torch.optim.adam import AdamState
    from tpugs_torch.optim.densify_adc import ADCState

    c = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return dataclasses.replace(
        state, params=c(state.params), alive=state.alive.clone(),
        adam=AdamState(m=c(state.adam.m), v=c(state.adam.v),
                       count=state.adam.count.clone()),
        adc=ADCState(*(getattr(state.adc, f).clone() for f in
                       ("grad_accum", "grad_count", "max_radii"))),
        key=state.key.copy())


def state_diffs(a, b) -> list:
    """The tensors of two TrainStates that are not bit-equal, by name."""
    import torch

    pairs = [(f"params/{k}", a.params[k], b.params[k]) for k in a.params]
    pairs += [(f"adam_m/{k}", a.adam.m[k], b.adam.m[k]) for k in a.params]
    pairs += [(f"adam_v/{k}", a.adam.v[k], b.adam.v[k]) for k in a.params]
    pairs += [("adam_count", a.adam.count, b.adam.count),
              ("alive", a.alive, b.alive)]
    pairs += [(f"adc/{f}", getattr(a.adc, f), getattr(b.adc, f))
              for f in ("grad_accum", "grad_count", "max_radii")]
    out = [name for name, x, y in pairs if not torch.equal(x, y)]
    if not (a.key == b.key).all():
        out.append("key")
    return out


def pool_bytes(runner):
    """Bytes of the device segments of a graph runner's memory pool (torch's
    memory snapshot); None where the snapshot names no pools."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    pool = tuple(runner.pool)
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == pool)


def port_kernel_counts(events) -> dict:
    """The port's kernels among a profile's device events -> launches by
    KERNELS name (K4 and K4b share a kernel: both count as composite_bwd)."""
    out = collections.Counter()
    names = (("align_copy_kernel", "align_copy"),
             ("composite_fwd_kernel", "composite_fwd"),
             ("composite_bwd_kernel", "composite_bwd"),
             ("segreduce_sorted_kernel", "segreduce"),
             ("segreduce_interval_kernel", "segreduce_interval"))
    for e in events:
        if "expand_kernel" in e.key:
            out["expand_carry" if "<true>" in e.key else "expand"] += e.count
        for frag, name in names:
            if frag in e.key:
                out[name] += e.count
    return {name: out.get(name, 0) for name in KERNELS}


def profiled(fn):
    """fn() under torch.profiler, then a synchronise -> (its result, the
    port's kernel launches among the device events, device busy ms, wall
    ms, the device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in dev_events) / 1e3
    return out, port_kernel_counts(dev_events), busy_ms, wall_ms, dev_events


def eager_run_k(train_step, params, adam_state, step0: float, k: int):
    """The bench's k steps as an eager loop (the card path before the
    graph): each step dispatched from the host."""
    import torch

    dev = params["means"].device
    steps = step0 + torch.arange(k, dtype=torch.float32, device=dev)
    losses = []
    for i in range(k):
        params, adam_state, loss = train_step(params, adam_state, steps[i])
        losses.append(loss)
    return params, adam_state, torch.stack(losses)


def graph_block(dev, label, shape, mode, launches_by):
    """The Trainer's multi-step (densify_mode `mode`) at a bench shape: (i)
    one eager step under sync debug mode "error" (ADC); (ii) a block of
    GRAPH_K steps replayed from the graph against GRAPH_K eager steps from
    the same state, bit for bit; (iii) its kernels counted in the profile
    of the block; (iv) capture seconds, pool bytes, peak memory. Returns
    the numbers printed."""
    import numpy as np
    import torch

    from tpugs_torch import bench
    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import (TrainConfig, TrainState,
                                           initial_key, make_train_multi_step,
                                           make_train_step)

    w, h, n = shape["img_w"], shape["img_h"], shape["n"]
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=bench.TILE,
                       tile_w=bench.TILE, pair_capacity=shape["pair_capacity"],
                       max_hits_per_tile=shape["max_hits"])
    params, alive, vm, intr, _ = bench.bench_scene(
        w, h, n, shape.get("scale_range"), dev)
    target = bench.bench_target(w, h, dev)
    tcfg = TrainConfig(densify_mode=mode)
    state0 = TrainState(params=params, alive=alive, adam=adam_init(params),
                        adc=adc_init(n, dev), key=initial_key(0))
    step = make_train_step(tcfg, cfg, 1.0)
    full = lambda v: torch.full((), float(v), device=dev)  # noqa: E731
    if mode == "adc":
        s1, _ = step(state0, target, vm, intr, full(0), 3)
        torch.cuda.synchronize()
        without_sync(lambda: step(s1, target, vm, intr, full(1), 3),
                     f"the Trainer's ADC step at {label}")
        del s1
    multi = make_train_multi_step(tcfg, cfg, 1.0)
    bank = (target[None], vm[None], intr[None])
    vi = np.zeros(GRAPH_K, np.int64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    s1, l1, _ = multi(state0, *bank, vi, 0, 3)
    float(l1[-1])
    first_s = time.perf_counter() - t0
    runner = multi.graphed[dev].runner
    check(runner.captures == 1 and runner.replays == GRAPH_K - 2,
          f"{label} {mode}: {runner.captures} captures, {runner.replays} "
          f"replays in the first block")
    ref = clone_state(s1)
    (s2, l2, st2), counts, busy, wall, _ = profiled(
        lambda: multi(s1, *bank, vi, GRAPH_K, 3))
    launches_by[f"graph_{label}_{mode}_block"] = counts
    check_launches(counts, SORTED_PATH, GRAPH_K,
                   f"{label} {mode} replayed block steps (profiler)")
    eager = []
    for j in range(GRAPH_K):
        ref, st = step(ref, target, vm, intr, full(GRAPH_K + j), 3)
        eager.append(st.loss)
    eager = torch.stack(eager)
    diffs = state_diffs(s2, ref)
    check(torch.equal(l2, eager) and not diffs,
          f"{label} {mode}: the replayed block differs from the eager steps"
          f" (losses max diff {float((l2 - eager).abs().max())}; tensors "
          f"{diffs})")
    check(bool(torch.isfinite(l2).all()) and not bool(st2.pair_overflow),
          f"{label} {mode}: losses {l2.tolist()}, overflow")
    # The block's time against the eager steps' in turns, host clock, one
    # host read each.
    times = {"graph": [], "eager": []}
    for _ in range(2):
        t0 = time.perf_counter()
        s1, l1, _ = multi(s1, *bank, vi, 0, 3)
        float(l1[-1])
        times["graph"].append((time.perf_counter() - t0) * 1e3 / GRAPH_K)
        st = ref
        t0 = time.perf_counter()
        for j in range(GRAPH_K):
            st, stats = step(st, target, vm, intr, full(j), 3)
        float(stats.loss)
        times["eager"].append((time.perf_counter() - t0) * 1e3 / GRAPH_K)
        del st, stats
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pool = pool_bytes(runner)
    print(f"graph {label} {mode} ({w}x{h}, {n} gaussians): first block "
          f"{first_s:.3f} s (2 eager steps, capture "
          f"{runner.capture_seconds[0]:.3f} s, {GRAPH_K - 2} replays); a "
          f"replayed block of {GRAPH_K} bit-equal to {GRAPH_K} eager steps "
          f"(losses {[round(x, 6) for x in l2.tolist()]}, every tensor of "
          f"the state); its kernels by profiler {counts}; busy share of the "
          f"profiled block {busy / wall:.4f} ({busy:.3f} of {wall:.3f} ms); "
          f"ms per step graph {[round(x, 3) for x in times['graph']]}, eager "
          f"{[round(x, 3) for x in times['eager']]}; graph pool {pool} B, "
          f"peak allocated {peak:.3f} GiB", flush=True)
    return {"capture_s": runner.capture_seconds[0], "pool_bytes": pool,
            "peak_gib": peak, "busy_share": busy / wall,
            "graph_ms": times["graph"], "eager_ms": times["eager"]}


def bench_round_share(dev, run_k, carry=False):
    """One timed 50k round (k steps and the host read of its last loss)
    through `run_k` under torch.profiler, after a warm-up round -> (busy
    share, busy ms, wall ms, the port's kernels counted)."""
    from tpugs_torch import bench

    k = bench.PRIMARY["k"]
    step, params, adam = bench_50k_step(dev, carry)
    params, adam, losses = run_k(step, params, adam, 0.0, k)
    float(losses[-1])
    _, counts, busy, wall, _ = profiled(
        lambda: float(run_k(step, params, adam, float(k), k)[2][-1]))
    return busy / wall, busy, wall, counts


def phase_graph(dev):
    """The train step as a captured CUDA graph (train/graph.py) at bench.py's
    two shapes: graph_block's checks for the Trainer's ADC step at both and
    its MCMC step at 50k (noise from the graph's generator); the bench's
    bare step under sync debug mode "error"; the bench through the graph
    (measure_config) and through the eager loop in turns, losses bit-equal,
    Mpix/s of both; the busy share of a profiled 50k round both ways; K1b
    in K1's place in a carried graph round (profiler). Returns the kernel
    launches of its profiled blocks and rounds."""
    import numpy as np
    import torch

    from tpugs_torch import bench

    launches_by = {}
    out = {}
    for label, shape in (("50k", bench.PRIMARY), ("garden", bench.GARDEN)):
        for mode in (("adc", "mcmc") if label == "50k" else ("adc",)):
            out[label, mode] = graph_block(dev, label, shape, mode,
                                           launches_by)

    step, params, adam = bench_50k_step(dev)
    params, adam, losses = eager_run_k(step, params, adam, 0.0, 2)
    float(losses[-1])
    without_sync(lambda: step(params, adam, torch.full((), 2.0, device=dev)),
                 "the bench's bare step")
    del step, params, adam

    rates = {}
    for label, shape in (("50k", bench.PRIMARY), ("garden", bench.GARDEN)):
        for way in ("graph", "eager", "graph", "eager"):
            orig = bench.run_k
            if way == "eager":
                bench.run_k = eager_run_k
            try:
                m = bench.measure_config(**shape, device=dev, carry=False)
            finally:
                bench.run_k = orig
            rates.setdefault((label, way), []).append(m)
        g, e = rates[label, "graph"][0], rates[label, "eager"][0]
        check(np.array_equal(g.losses, e.losses),
              f"bench {label}: graph losses differ from the eager loop's by "
              f"up to {float(np.abs(g.losses - e.losses).max())}")
        print(f"bench {label} in turns (graph, eager, graph, eager), the "
              f"losses of all {g.losses.shape[0]} steps bit-equal: Mpix/s "
              f"graph {[round(m.mpix_s, 4) for m in rates[label, 'graph']]},"
              f" eager {[round(m.mpix_s, 4) for m in rates[label, 'eager']]};"
              f" it/s graph {[round(m.its, 2) for m in rates[label, 'graph']]}"
              f", eager {[round(m.its, 2) for m in rates[label, 'eager']]}",
              flush=True)

    for way, run_k in (("graph", bench.run_k), ("eager", eager_run_k)):
        share, busy, wall, counts = bench_round_share(dev, run_k)
        if way == "graph":
            launches_by["graph_bench_50k_round"] = counts
            check_launches(counts, SORTED_PATH, bench.PRIMARY["k"],
                           "graphed 50k round steps (profiler)")
        print(f"bench 50k round ({way}) under torch.profiler: busy share "
              f"{share:.4f} ({busy:.3f} of {wall:.3f} ms); kernels {counts}",
              flush=True)
    share, busy, wall, counts = bench_round_share(dev, bench.run_k, True)
    launches_by["graph_bench_50k_carry_round"] = counts
    check_launches(counts, CARRY_PATH, bench.PRIMARY["k"],
                   "graphed carried 50k round steps (profiler)")
    print(f"bench 50k carried round (graph): K1b in K1's place by profiler "
          f"{counts}; busy share {share:.4f}", flush=True)
    return launches_by


def garden_params(dev):
    from tpugs_torch.utils.synthetic import synthetic_params

    return synthetic_params(TRAIN_N, seed=0, device=dev,
                            scale_range=(0.002, 0.015))


def frame_grads(dev, params, pre: bool = False, **render_kw):
    """One garden-shape frame's gradients of every parameter under the
    train step's loss against a seeded target, the launches of that run
    alone and its image: through render() (render_kw), or with pre=True
    through the pre-aligned path (bin_gaussians_aligned + CompositePre)."""
    import torch

    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops import composite as C
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.rasterize_tiled import tiles_to_image
    from tpugs_torch.ops.render import RasterConfig, render
    from tpugs_torch.train.loss import combined_loss
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy

    w, h = TRAIN_W, TRAIN_H
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=32, tile_w=32,
                       pair_capacity=TRAIN_PAIR_CAPACITY,
                       max_hits_per_tile=TRAIN_MAX_HITS)
    target = torch.rand((h, w, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tp = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    n = tp["means"].shape[0]
    view = (torch.ones(n, dtype=torch.bool, device=dev),
            torch.eye(4, device=dev),
            torch.from_numpy(synthetic_intrinsics_numpy(w, h)).to(dev))
    bg = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    if pre:
        proj = project_gaussians(*[tp[k] for k in NAMES], *view, w, h, 3)
        with torch.no_grad():
            a = B.bin_gaussians_aligned(proj, w, h, 32, 32,
                                        cfg.pair_capacity, C.p_aligned(cfg))
        overflow = a.overflow | (
            (a.tile_stop - a.tile_start).max() > cfg.max_hits_per_tile)
        color_t, _, _ = C.CompositePre.apply(
            cfg, a.tile_start, a.tile_stop, a.pair_gauss, a.pair_valid,
            proj.means2d, proj.conic, proj.rgb, proj.opac, bg)
        color = tiles_to_image(cfg, color_t)[:h, :w]
    else:
        out = render(*[tp[k] for k in NAMES], *view, cfg, 3, bg, **render_kw)
        overflow = out.pair_overflow | out.hit_overflow
        color = out.color
    grads = torch.autograd.grad(combined_loss(color, target),
                                [tp[k] for k in NAMES])
    torch.cuda.synchronize()
    launches = read_launches()
    check(not bool(overflow), "garden frame overflowed")
    for name, g in zip(NAMES, grads):
        check(bool(torch.isfinite(g).all()), f"d {name} not finite")
    return grads, launches, color.detach()


def compare_grads(got, ref, what: str) -> float:
    """The worst parameter group's share of elements within
    GRAD_RTOL |ref| + GRAD_ATOL_REL max|ref|; raises below MIN_GRAD_MATCH."""
    shares = {name: close_share(a, b) for name, a, b in zip(NAMES, got, ref)}
    worst = min(shares.values())
    check(worst >= MIN_GRAD_MATCH, f"{what}: gradients within tolerance of "
          f"the sorted path's on only {shares}")
    return worst


def phase_garden_grad_paths(dev, errs):
    """At train-garden-1M: the default sorted backward, the classic branch
    (SORTED_SEGRED_MIN raised: K4b and K6) and the scatter-add gradient of
    render(need_grads=False) (K4b), one frame each; the classic and scatter
    gradients held against the sorted ones, K4b against K4 transposed on
    the sorted run's inputs (bit-identical), the scatter run twice. Returns
    the launches of the classic and scatter runs."""
    import torch

    from tpugs_torch.ops import composite, composite_t, pack

    params = garden_params(dev)
    with capturing(composite_t, "composite_backward") as k4:
        sorted_g, sorted_l, _ = frame_grads(dev, params)
    check_launches(sorted_l, SORTED_PATH, 1, "sorted frames")
    composite.SORTED_SEGRED_MIN = 1 << 62
    try:
        classic_g, classic_l, _ = frame_grads(dev, params)
    finally:
        composite.SORTED_SEGRED_MIN = 0
    check_launches(classic_l, CLASSIC_PATH, 1, "classic frames")
    w_classic = compare_grads(classic_g, sorted_g, "classic branch")
    scatter_g, scatter_l, _ = frame_grads(dev, params, need_grads=False)
    check_launches(scatter_l, ("expand", "align_copy", "composite_fwd",
                               "composite_bwd_entry"), 1, "scatter frames")
    w_scatter = compare_grads(scatter_g, sorted_g, "scatter gradient")
    again, _, _ = frame_grads(dev, params, need_grads=False)
    same = all(torch.equal(a, b) for a, b in zip(scatter_g, again))
    with torch.no_grad():
        args = k4[0]
        rows = composite_t.composite_backward(*args, transposed_out=False)
        cols = composite_t.composite_backward(*args)
        valid = args[3][pack.VALID_ROW] > 0
        err = float((rows[valid] - cols.T[valid]).abs().max())
    check(err == 0.0, f"K4b differs from K4 transposed by {err}")
    errs["composite_bwd_entry"] = max(errs.get("composite_bwd_entry", 0.0), err)
    print(f"garden grad paths: classic (K4b + K6) and scatter (K4b + "
          f"index_add_) gradients within tolerance of the sorted path's on "
          f">= {w_classic:.6f} / {w_scatter:.6f} of elements (worst group); "
          f"K4b bit-identical to K4 transposed; two scatter runs "
          f"{'bit-identical' if same else 'differ (index_add_ atomics)'}",
          flush=True)
    return classic_l, scatter_l


def expand_carry_row(dev, args, errs, where: str):
    """K1b on one frame's captured inputs: held against its plain version
    (bit-identical) and timed beside it; returns its kernel row."""
    import torch

    from tpugs_torch.ops import expand

    got = without_sync(lambda: expand.expand_pairs(*args),
                       "expand_pairs (carry mode)")
    check(all(torch.equal(a, b) for a, b in
              zip(got, expand.expand_pairs_plain(*args))),
          f"K1b differs from its plain version on the {where}")
    errs["expand_carry"] = 0.0
    itab, p_out = args[0], args[2]
    k_ms = cuda_ms(lambda: expand.expand_pairs(*args))
    alone_ms = timed_alone(lambda: expand.expand_pairs(*args))
    pl_ms = cuda_ms(lambda: expand.expand_pairs_plain(*args), reps=3)
    step1_expand(itab, p_out, alone_ms, "expand_carry", where)
    return Row("expand_carry", k_ms, alone_ms, pl_ms,
               expand_bytes(itab, p_out, True), owned_slots(itab, p_out) * 16,
               extra={"host_ms": host_ms(lambda: expand.expand_pairs(*args))})


def phase_carry(dev, cli_params, errs):
    """render(carry_attrs=True) against carry_attrs=False at the render CLI's
    frame 0 (1920x1080, presort "fastest") and at the train frame (garden,
    presort "auto"): images equal, K1b against its plain version, the frame
    timed both ways. Returns K1b's row (train frame) and the launches of
    the carried train frame."""
    import torch

    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops import expand
    from tpugs_torch.ops.render import RasterConfig, render
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy
    from tpugs_torch.viewer.camera import orbit_trajectory

    cam = orbit_trajectory(cli_params["means"], CLI_FRAMES, CLI_W, CLI_H)[0]
    frames = {
        "render frame": (
            params_from_numpy(cli_params, dev),
            torch.as_tensor(cam.world_to_camera(), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(cam.intrinsics_array(), device=dev),
            RasterConfig(img_h=CLI_H, img_w=CLI_W, tile_h=32, tile_w=32,
                         pair_capacity=CLI_PAIR_CAPACITY,
                         max_hits_per_tile=CLI_MAX_HITS), "fastest"),
        "train frame": (
            garden_params(dev), torch.eye(4, device=dev),
            torch.from_numpy(synthetic_intrinsics_numpy(TRAIN_W, TRAIN_H)).to(dev),
            RasterConfig(img_h=TRAIN_H, img_w=TRAIN_W, tile_h=32, tile_w=32,
                         pair_capacity=TRAIN_PAIR_CAPACITY,
                         max_hits_per_tile=TRAIN_MAX_HITS), "auto"),
    }
    row, launches = None, None
    for where, (p, vm, intr, cfg, presort) in frames.items():
        n = p["means"].shape[0]
        alive = torch.ones(n, dtype=torch.bool, device=dev)

        def frame(carry):
            return render(*[p[k] for k in NAMES], alive, vm, intr, cfg, 3,
                          torch.zeros(3, device=dev), presort=presort,
                          need_grads=False, carry_attrs=carry)

        with torch.no_grad():
            base = frame(False)
            torch.cuda.synchronize()
            reset_launches()
            with capturing(expand, "expand_pairs", carry_mode) as k1b:
                out = frame(True)
            torch.cuda.synchronize()
            run_launches = read_launches()
            check_launches(run_launches, ("expand_carry", "align_copy",
                                          "composite_fwd"), 1,
                           f"carried {where}s")
            err = max(float((out.color - base.color).abs().max()),
                      float((out.final_T - base.final_T).abs().max()))
            check(err == 0.0, f"carry_attrs changes the {where} by {err}")
            ms = {c: cuda_ms(lambda: frame(c), reps=5) for c in (False, True)}
            r = expand_carry_row(dev, k1b[0], errs, where)
        print(f"carry {where}: {int(out.num_pairs)} pairs, images equal to "
              f"the gathered path's (max abs err 0), K1b bit-identical to its "
              f"plain version; frame {ms[False]:.3f} ms gathered, "
              f"{ms[True]:.3f} ms carried; K1b {r[1]:.4f} ms", flush=True)
        if where == "train frame":
            row, launches = r, run_launches
    return [row], launches


def large_scene_params(dev):
    """train-garden-1M's 1M gaussians, then 2^24 - 1M more behind the
    identity camera (tpugs_torch.utils.synthetic.pad_behind_camera)."""
    from tpugs_torch.utils.synthetic import pad_behind_camera

    return pad_behind_camera(garden_params(dev), LARGE_N)


def phase_large_scene(dev, errs):
    """The port's train step at N = 2^24 (the garden shape; the classic
    branch, K4b and K6 once per step, K4 and K5 never): 2 warm-up and 5
    timed steps, peak memory; K4b, K6 and K1 held against their plain
    versions on step 0's inputs and timed there (K4b's and K6's rows of the
    kernels line, K1's 2^24 figures), and the table build timed.
    Returns (rows, launches, ms per step, peak GB, the expand row's 2^24
    figures)."""
    import numpy as np
    import torch

    from tpugs_torch.ops import composite_t, expand, segreduce
    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import (TrainConfig, TrainState,
                                           initial_key, make_train_step)
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy

    w, h, n = TRAIN_W, TRAIN_H, LARGE_N
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=32, tile_w=32,
                       pair_capacity=TRAIN_PAIR_CAPACITY,
                       max_hits_per_tile=TRAIN_MAX_HITS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = large_scene_params(dev)
    state = TrainState(params=params,
                       alive=torch.ones(n, dtype=torch.bool, device=dev),
                       adam=adam_init(params), adc=adc_init(n, dev),
                       key=initial_key(0))
    train_step = make_train_step(TrainConfig(densify_mode="none"), cfg, 1.0)
    viewmat = torch.eye(4, device=dev)
    intr = torch.from_numpy(synthetic_intrinsics_numpy(w, h)).to(dev)
    target = torch.rand((h, w, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms, losses = [], []
    steps = LARGE_WARMUP + LARGE_STEPS
    torch.cuda.synchronize()
    reset_launches()
    with capturing(composite_t, "composite_backward", entry_major) as k4b, \
            capturing(segreduce, "segment_reduce") as k6, \
            capturing(expand, "expand_pairs") as k1:
        for i in range(steps):
            ev0.record()
            state, stats = train_step(state, target, viewmat, intr,
                                      torch.tensor(float(i)), 3)
            ev1.record()
            torch.cuda.synchronize()
            ms.append(ev0.elapsed_time(ev1))
            losses.append(float(stats.loss))
            check(not bool(stats.pair_overflow) and not bool(stats.hit_overflow),
                  f"2^24 step {i} overflowed")
            check(np.isfinite(losses[-1]), f"2^24 step {i}: loss {losses[-1]}")
            check(all(bool(torch.isfinite(m).all())
                      for m in state.adam.m.values()),
                  f"2^24 step {i}: gradients not finite")
            if i == 0:
                pairs0 = int(stats.num_pairs)
    launches = read_launches()
    check_launches(launches, CLASSIC_PATH, steps, "2^24 train steps")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.mean(ms[LARGE_WARMUP:]))
    print(f"train step {w}x{h} N=2^24 SH3 (classic branch): {step_ms:.3f} "
          f"ms/step (steps {', '.join(f'{m:.1f}' for m in ms)} ms); step 0: "
          f"{pairs0} pairs; loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak "
          f"memory {peak_gb:.2f} GiB (max_memory_allocated); launches "
          f"{launches}", flush=True)
    del state, params
    torch.cuda.empty_cache()
    with torch.no_grad():
        rows = classic_kernel_rows(dev, k4b[0], k6[0], errs)
        k1_extra = large_expand(k1[0], errs)
        del k4b, k6, k1
        time_table_build(dev)
    return rows, launches, step_ms, peak_gb, k1_extra


def large_expand(a1, errs):
    """K1 on the 2^24 step's step-0 inputs: held against its plain version
    (bit-identical), timed as called and alone, and alone on the same
    inputs cut to their first TRAIN_N gaussians (the same slots: the rest
    lie behind the camera and own none). Returns the expand row's 2^24
    figures."""
    import torch

    from tpugs_torch.ops import expand

    itab, ftab, p_out = a1[:3]
    got = expand.expand_pairs(*a1)
    check(all(torch.equal(a, b) for a, b in
              zip(got, expand.expand_pairs_plain(*a1))),
          "K1 differs from its plain version on the 2^24 step's frame")
    errs.setdefault("expand", 0.0)
    k_ms = cuda_ms(lambda: expand.expand_pairs(*a1))
    alone_ms = timed_alone(lambda: expand.expand_pairs(*a1))
    cut = (itab[:, :TRAIN_N].contiguous(), ftab[:, :TRAIN_N].contiguous()) \
        + tuple(a1[2:])
    check(all(torch.equal(a, b) for a, b in
              zip(expand.expand_pairs(*cut), got)),
          "the 2^24 frame's expansion cut to its first 1M gaussians differs")
    cut_ms = timed_alone(lambda: expand.expand_pairs(*cut))
    bound_ms, bound_by = bound(expand_bytes(itab, p_out, False),
                               owned_slots(itab, p_out) * 16)
    step1_expand(itab, p_out, alone_ms, "expand", "2^24 step 0")
    print(f"2^24 train frame expand: {k_ms:.4f} ms as called, "
          f"{alone_ms:.4f} ms alone, bound {bound_ms:.4f} ms ({bound_by}), "
          f"bit-identical to its plain version; cut to its first {TRAIN_N} "
          f"gaussians (the same {p_out} slots) {cut_ms:.4f} ms alone",
          flush=True)
    return {"ms_2p24": k_ms, "alone_ms_2p24": alone_ms,
            "bound_ms_2p24": bound_ms, "alone_ms_2p24_cut_1m": cut_ms}


def time_table_build(dev):
    """binning.expand_inputs, which builds the expand kernel's itab and
    ftab (rects, cull radii, the offsets' cumsum, two stacks, the host
    read of the pair count), timed on the garden frame's projection at 1M
    and at 2^24 gaussians (CUDA events around each call)."""
    import torch

    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy

    intr = torch.from_numpy(synthetic_intrinsics_numpy(TRAIN_W, TRAIN_H)).to(dev)
    ms = {}
    for label, make in (("1M", garden_params), ("2^24", large_scene_params)):
        p = make(dev)
        n = p["means"].shape[0]
        proj = project_gaussians(*[p[k] for k in NAMES],
                                 torch.ones(n, dtype=torch.bool, device=dev),
                                 torch.eye(4, device=dev), intr, TRAIN_W,
                                 TRAIN_H, 3)
        del p
        ms[label] = cuda_ms(lambda: B.expand_inputs(
            proj, TRAIN_W, TRAIN_H, 32, 32, TRAIN_PAIR_CAPACITY))
        del proj
    print(f"table build (binning.expand_inputs) on the garden frame: 1M "
          f"{ms['1M']:.4f} ms, 2^24 {ms['2^24']:.4f} ms (its host read of "
          f"the pair count included)", flush=True)


def classic_kernel_rows(dev, a4b, a6, errs):
    """K4b and K6 on the inputs a 2^24 train step gave them: each held
    against its plain version (bit-identical) and timed beside it, K6 also
    beside torch.segment_reduce and index_add_ of the same gaussian-major
    rows."""
    import torch

    from tpugs_torch.ops import composite_t, pack, segreduce

    cfg, astart, astop, attr, k_last = a4b[0], a4b[1], a4b[2], a4b[3], a4b[7]
    got = without_sync(lambda: composite_t.composite_backward(
        *a4b, transposed_out=False), "composite_backward (entry-major)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = composite_t.composite_backward_plain(*a4b, transposed_out=False)
    torch.cuda.synchronize()
    pl_ms = (time.perf_counter() - t0) * 1e3
    valid = attr[pack.VALID_ROW] > 0
    check(bool(torch.isfinite(got[valid]).all()), "K4b output not finite")
    err4 = float((got[valid] - ref[valid]).abs().max())
    check(err4 == 0.0, f"K4b differs from its plain version by {err4}")
    errs["composite_bwd_entry"] = max(errs.get("composite_bwd_entry", 0.0), err4)
    k_ms = cuda_ms(lambda: composite_t.composite_backward(
        *a4b, transposed_out=False))
    alone_ms = timed_alone(lambda: composite_t.composite_backward(
        *a4b, transposed_out=False))
    entries = int((astop - astart).long().sum())
    walked = int(((k_last.long() + 1) * in_image(cfg, dev)).sum())
    rows = [Row("composite_bwd_entry", k_ms, alone_ms, pl_ms,
                2 * entries * 36 + cfg.num_tiles * cfg.pix * 24, 53 * walked)]
    step1_backward(a4b, alone_ms, "2^24 step 0", transposed_out=False)

    d_rows, red_start, red_count, exp_end, n = a6
    got = without_sync(lambda: segreduce.segment_reduce(*a6), "segment_reduce")
    err6 = float((got - segreduce.segment_reduce_plain(
        d_rows, red_start, red_count, n)).abs().max())
    check(err6 == 0.0, f"K6 differs from its plain version by {err6}")
    errs["segreduce_interval"] = err6
    k_ms = cuda_ms(lambda: segreduce.segment_reduce(*a6))
    alone_ms = timed_alone(lambda: segreduce.segment_reduce(*a6))
    pl_ms = cuda_ms(lambda: segreduce.segment_reduce_plain(
        d_rows, red_start, red_count, n), reps=3)
    # The intervals the step fed K6: how long they run.
    length = red_count.long()
    nonempty = torch.sort(length[length > 0]).values
    q = [int(nonempty[int(f * (nonempty.shape[0] - 1))])
         for f in (0.5, 0.99, 0.999)]
    longer = {t: int((length > t).sum()) for t in (8, 16, 32, 64, 128)}
    empty = float((length == 0).float().mean())
    print(f"K6 intervals at 2^24: {n} gaussians, {empty:.6f} empty; "
          f"non-empty lengths median {q[0]}, 99th pct {q[1]}, "
          f"99.9th pct {q[2]}, max {int(length.max())}; longer than "
          f"{longer}", flush=True)
    # Library yardsticks. torch.segment_reduce computes K6's function, zeros
    # included, where the intervals partition the owned slots [0, end),
    # end = min(total, exp_end) (the main path's: binning.reduce_intervals;
    # exp_end is the static capacity); index_add_ by each row's gaussian
    # adds the same rows but excludes zeroing its output and expanding the
    # gaussian ids, so it is printed beside it.
    end = int(length.sum())
    contiguous = bool((red_start[1:] == red_start[:-1] + red_count[:-1]).all()) \
        and int(red_start[0]) == 0 and end <= exp_end
    check(contiguous, "the 2^24 step's intervals do not partition [0, end)")
    seg_rows = d_rows[:end]
    seg = torch.segment_reduce(seg_rows, "sum", lengths=red_count, axis=0)
    seg_err = float((seg.T - got).abs().max())
    check(seg_err <= 1e-4 * float(got.abs().max()),
          f"torch.segment_reduce yardstick differs from K6 by {seg_err}")
    lib_ms = cuda_ms(lambda: torch.segment_reduce(seg_rows, "sum",
                                                  lengths=red_count, axis=0))
    gid = torch.repeat_interleave(torch.arange(n, device=dev), length)
    acc = torch.zeros((n, pack.NUM_ATTR), device=dev)
    add_ms = cuda_ms(lambda: acc.index_add_(0, gid, seg_rows))
    lib = torch.zeros_like(acc).index_add_(0, gid, seg_rows).T
    lib_err = float((lib - got).abs().max())
    check(lib_err <= 1e-4 * float(got.abs().max()),
          f"index_add_ yardstick differs from K6 by {lib_err}")
    # The floor of K6's stores: zeroing its [9, n] output alone.
    blank = torch.empty_like(got)
    memset_ms = cuda_ms(blank.zero_)
    slots = int(length.sum())
    rows.append(Row("segreduce_interval", k_ms, alone_ms, pl_ms,
                    slots * 36 + n * 8 + n * 36, slots * pack.NUM_ATTR, lib_ms,
                    "torch.segment_reduce",
                    {"index_add_ms": add_ms,
                     "index_add": "excludes zeroing its output and the gid "
                                  "expansion",
                     "memset_ms": memset_ms,
                     "memset": "zeroing the [9, n] output alone"}))
    print(f"classic kernels at 2^24: K4b on {entries} entries, {walked} "
          f"in-image (pixel, entry) pairs, bit-identical to its plain version; "
          f"K6 over {slots} slots of {exp_end} into {n} gaussians, "
          f"bit-identical; torch.segment_reduce {lib_ms:.4f} ms (max abs diff "
          f"{seg_err:.3g}); index_add_ {add_ms:.4f} ms without zeroing its "
          f"output or expanding the ids (max abs diff {lib_err:.3g}); "
          f"zeroing the output alone {memset_ms:.4f} ms",
          flush=True)
    return rows


def phase_train_cli(tmp, dev):
    """The train CLI on a GT dataset at the garden shape; returns the
    launches of its run."""
    import numpy as np
    import torch

    from tpugs_torch.apps import train as train_app
    from tpugs_torch.core import init as init_mod
    from tpugs_torch.io.checkpoint import load_train_checkpoint
    from tpugs_torch.utils.gt_scene import make_gt_model, write_gt_dataset

    ds = os.path.join(tmp, "gt_scene")
    out_dir = os.path.join(tmp, "train_out")
    t0 = time.perf_counter()
    model = make_gt_model(TRAIN_N, device=dev)
    write_gt_dataset(ds, model, num_views=TRAIN_CLI_VIEWS, width=TRAIN_W,
                     height=TRAIN_H, sparse_points=TRAIN_N, sh_degree=3)
    del model
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0

    knn_s = []
    knn = init_mod.mean_knn_distance

    def timed_knn(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = knn(*args, **kw)
        torch.cuda.synchronize()
        knn_s.append(time.perf_counter() - t)
        return d

    argv = ["-d", ds, "-o", out_dir, "-i", str(TRAIN_CLI_STEPS),
            "--no-densify", "--sh-degree", "3", "--log-every", "5",
            "--save-every", "0", "--max-hits", str(TRAIN_MAX_HITS),
            "--device", dev.type]
    log = io.StringIO()
    init_mod.mean_knn_distance = timed_knn
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            rc = train_app.main(argv)
    finally:
        init_mod.mean_knn_distance = knn
    cli_s = time.perf_counter() - t0
    captures, replays = graph_totals()
    launches = executed(read_launches(), SORTED_PATH, captures, replays)
    text = log.getvalue()
    check(rc == 0, f"train CLI returned {rc}")
    check(captures >= 1 and replays > 0,
          f"train CLI: {captures} graph captures, {replays} replays")
    for line in text.splitlines():
        if "OVERFLOW" in line or line.startswith(("auto pair", "trained")):
            print(f"train cli: {line}", flush=True)
    hist = [json.loads(x) for x in open(os.path.join(out_dir, "history.jsonl"))]
    check([r["step"] for r in hist] == list(range(0, TRAIN_CLI_STEPS, 5)),
          f"history steps {[r['step'] for r in hist]}")
    check(all(np.isfinite(r["loss"]) for r in hist), "non-finite loss")
    last_log = [ln for ln in text.splitlines()
                if ln.startswith(f"[{hist[-1]['step']}] loss=")]
    check(f"[{TRAIN_CLI_STEPS}] OVERFLOW" not in text and len(last_log) == 1
          and "OVERFLOW" not in last_log[0],
          "overflow left after the grow policy")
    check_launches(launches, SORTED_PATH, TRAIN_CLI_STEPS, "CLI steps")
    m = re.search(r"trained (\d+) iters in ([\d.]+)s \(([\d.]+) it/s\)", text)
    check(m is not None and int(m.group(1)) == TRAIN_CLI_STEPS,
          "no 'trained' line")
    state, step = load_train_checkpoint(
        os.path.join(out_dir, f"ckpt_{TRAIN_CLI_STEPS:07d}.npz"), dev)
    check(step == TRAIN_CLI_STEPS and int(state.adam.count) == TRAIN_CLI_STEPS,
          "checkpoint step")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()),
          "checkpoint params not finite")
    steps_s = float(m.group(2))
    print(f"train cli {TRAIN_W}x{TRAIN_H}, {TRAIN_CLI_VIEWS} views, 1M "
          f"sparse points: {float(m.group(3)):.2f} it/s; losses "
          f"{[round(r['loss'], 5) for r in hist]}; seconds: dataset write "
          f"{write_s:.1f}, CLI {cli_s:.1f} = init {cli_s - steps_s:.1f} "
          f"(kNN {sum(knn_s):.1f}) + steps {steps_s:.1f}; {replays} of the "
          f"steps graph replays ({captures} captures); launches "
          f"{launches}", flush=True)
    return launches


def sync_warnings(fn) -> list:
    """The operations of fn() that made the host wait for the device
    (torch's sync debug mode "warn"), as "file:line" of their callers."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def densify_dataset(tmp, dev) -> tuple:
    """The GT dataset of the densify phase -> (its path, seconds)."""
    import torch

    from tpugs_torch.utils.gt_scene import make_gt_model, write_gt_dataset

    ds = os.path.join(tmp, "gt_densify")
    t0 = time.perf_counter()
    model = make_gt_model(TRAIN_N, device=dev)
    write_gt_dataset(ds, model, num_views=DENSIFY_VIEWS, width=TRAIN_W,
                     height=TRAIN_H, sparse_points=DENSIFY_POINTS,
                     sh_degree=3)
    del model
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t0


def run_train_cli(tmp, ds, name: str, config: dict, steps: int, extra=()):
    """The train CLI on ds with `config` as its -c file. Records the
    Trainer, the state and arguments of its first and last events, each
    event's device time (CUDA events), the prune causes before each ADC
    event and each evaluation with its launches. Returns (log text,
    launches of the run, record)."""
    import torch

    from tpugs_torch.apps import train as train_app
    from tpugs_torch.optim.densify_adc import WS_PRUNE_FRACTION
    from tpugs_torch.train import trainer as trainer_mod

    rec = {"events_ms": [], "evals": [], "first": None, "trainer": None,
           "prune_causes": []}
    base = trainer_mod.Trainer
    pending = []

    def prune_causes(tr, state):
        """The alive gaussians an ADC event would prune for each cause
        (opacity, screen radius, world size), left on the device."""
        cfg = tr.cfg.adc
        a = state.alive
        big = torch.amax(torch.exp(state.params["log_scales"]), dim=-1)
        return torch.stack([torch.sum(a & (torch.sigmoid(
            state.params["opacity_logits"]) < cfg.opacity_threshold)),
            torch.sum(a & (state.adc.max_radii > cfg.max_screen_size)),
            torch.sum(a & (big > WS_PRUNE_FRACTION * tr.scene_extent))])

    def timed(tr, fn):
        def event(state, **kw):
            # The state's tensors are the train graph's buffers, which the
            # next block overwrites: keep a copy.
            kept = (clone_state(state), kw)
            if rec["first"] is None:
                rec["first"] = kept
            rec["last"] = kept
            if tr.cfg.densify_mode == "adc":
                rec["prune_causes"].append(prune_causes(tr, state))
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(state, **kw)
            t1.record()
            pending.append((t0, t1))
            return out
        return event

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            rec["trainer"] = self
            self._densify = timed(self, self._densify)
            self._relocate = timed(self, self._relocate)

        def evaluate(self, sh_degree=None):
            before = read_launches()
            res = super().evaluate(sh_degree)
            after = read_launches()
            rec["evals"].append((res, {k: after[k] - before[k]
                                       for k in after}))
            return res

    cfg_path = os.path.join(tmp, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    out_dir = os.path.join(tmp, f"{name}_out")
    argv = ["-d", ds, "-o", out_dir, "-c", cfg_path, "-i", str(steps),
            "--capacity", str(DENSIFY_CAPACITY), "--sh-degree", "3",
            "--log-every", "20", "--save-every", "0", "--max-hits",
            str(TRAIN_MAX_HITS), "--device", "cuda", *extra]
    log = io.StringIO()
    trainer_mod.Trainer = Recorded
    reset_launches()
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with contextlib.redirect_stdout(log):
            rc = train_app.main(argv)
    finally:
        trainer_mod.Trainer = base
    launches = read_launches()
    rec["graph"] = graph_totals()
    runner = rec["trainer"]._multi_step.graphed[dev].runner
    rec["capture_s"] = runner.capture_seconds
    rec["pool_bytes"] = pool_bytes(runner)
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.synchronize()
    rec["events_ms"] = [a.elapsed_time(b) for a, b in pending]
    rec["prune_causes"] = [c.tolist() for c in rec["prune_causes"]]
    rec["out_dir"] = out_dir
    check(rc == 0, f"{name}: train CLI returned {rc}")
    text = log.getvalue()
    for line in text.splitlines():
        print(f"{name}: {line}", flush=True)
    hist = [json.loads(x) for x in open(os.path.join(out_dir,
                                                     "history.jsonl"))]
    check([r["step"] for r in hist] == list(range(0, steps, 20)),
          f"{name}: history steps {[r['step'] for r in hist]}")
    check(all(math.isfinite(r["loss"]) for r in hist),
          f"{name}: non-finite loss")
    last_log = [ln for ln in text.splitlines()
                if ln.startswith(f"[{hist[-1]['step']}] loss=")]
    check(f"[{steps}] OVERFLOW" not in text and len(last_log) == 1
          and "OVERFLOW" not in last_log[0],
          f"{name}: overflow left after the grow policy")
    m = re.search(r"trained (\d+) iters in ([\d.]+)s \(([\d.]+) it/s\)", text)
    check(m is not None and int(m.group(1)) == steps,
          f"{name}: no 'trained' line")
    rec["its"] = float(m.group(3))
    rec["n0"] = hist[0]["n"]
    rec["losses"] = [r["loss"] for r in hist]
    return text, launches, rec


def event_on_card_and_cpu(dev, kind: str, tr, recorded):
    """An event's recorded state through adc_densify (kind "densify") or
    relocate + grow ("relocate") on the card and on the CPU with the same
    pre-drawn draws: masks, stats and slot assignment identical, params
    within EVENT_RTOL. Returns the CPU's seconds."""
    import torch

    from tpugs_torch.optim.densify_adc import ADCState, adc_densify
    from tpugs_torch.optim.densify_mcmc import grow, relocate

    state, kw = recorded
    nc = state.alive.shape[0]
    cfg, extent = tr.cfg, tr.scene_extent
    gen = torch.Generator().manual_seed(0)
    draws = (torch.randn((2, nc, 3), generator=gen),
             torch.rand((2, nc), generator=gen))
    outs, cpu_s = [], 0.0
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        p = {k: v.to(d) for k, v in state.params.items()}
        alive = state.alive.to(d)
        noise, u = (x.to(d) for x in draws)
        if kind == "densify":
            adc = ADCState(*(getattr(state.adc, f).to(d) for f in
                             ("grad_accum", "grad_count", "max_radii")))
            p, alive2, changed, _, stats = adc_densify(
                cfg.adc, p, alive, adc, extent, kw["size_pruning_active"],
                noise1=noise[0], noise2=noise[1])
            masks = (alive2, changed)
        else:
            p, changed, stats = relocate(cfg.mcmc, p, alive, extent, u=u[0],
                                         jitter=noise[0])
            p, alive2, grown, n_new = grow(cfg.mcmc, p, alive, extent,
                                           u=u[1], jitter=noise[1])
            stats = dict(stats, num_added=n_new)
            masks = (changed, alive2, grown)
        outs.append((p, masks, {k: int(v) for k, v in stats.items()}))
        cpu_s = time.perf_counter() - t0
    (p, masks, stats), (rp, rmasks, rstats) = outs
    check(stats == rstats, f"{kind}: stats on the card {stats}, CPU {rstats}")
    for a, b in zip(masks, rmasks):
        check(torch.equal(a.cpu(), b), f"{kind}: a mask differs card/CPU")
    copied = ("quats", "sh") + (("opacity_logits",) if kind == "densify"
                                else ("means",) if cfg.mcmc.exact_relocation
                                else ())
    for k, v in p.items():
        v = v.cpu()
        if k in copied:
            check(torch.equal(v, rp[k]), f"{kind}: {k} rows differ card/CPU")
        else:
            err = float(((v - rp[k]).abs()
                         / rp[k].abs().clamp(min=1e-6)).max())
            check(err <= EVENT_RTOL, f"{kind}: {k} rel err {err:.3g} card/CPU")
    print(f"{kind} event card vs CPU on an event's state (Nc {nc}): "
          f"identical masks and stats {stats}; CPU {cpu_s:.1f} s",
          flush=True)
    return cpu_s


def phase_train_densify(tmp, dev, card):
    """The train CLI with ADC (its default) and with --mcmc on the densify
    dataset, with evaluation; returns the launches of the ADC run, of its
    evaluations and of the MCMC run."""
    import dataclasses

    import numpy as np
    import torch

    from tpugs_torch.io.checkpoint import load_train_checkpoint
    from tpugs_torch.train.trainer import (make_densify_step,
                                           make_relocate_step,
                                           make_train_step)

    ds, write_s = densify_dataset(tmp, dev)
    print(f"densify dataset: {DENSIFY_VIEWS} views {TRAIN_W}x{TRAIN_H} of a "
          f"1M GT model, {DENSIFY_POINTS} sparse points: {write_s:.1f} s",
          flush=True)

    # ADC: the CLI's default mode.
    text, adc_launches, rec = run_train_cli(tmp, ds, "adc", ADC_CONFIG,
                                            ADC_STEPS)
    ev = [tuple(map(int, m)) for m in re.findall(
        r"\[(\d+)\] densify: \+(\d+) cloned, \+(\d+) split, -(\d+) pruned, "
        r"N=(\d+)", text)]
    check([e[0] for e in ev] == [20, 40, 60, 80, 100],
          f"densify events at {[e[0] for e in ev]}")
    check("[60] opacity reset" in text, "no opacity reset at 60")
    check(any(e[1] + e[2] > 0 for e in ev), "no event cloned or split")
    check(any(e[3] > 0 for e in ev), "no event pruned")
    before = [rec["n0"]] + [e[4] for e in ev[:-1]]
    check(any(e[4] > n for e, n in zip(ev, before)),
          f"N {rec['n0']} -> {[e[4] for e in ev]}: no event grew N")
    state, step = load_train_checkpoint(
        os.path.join(rec["out_dir"], f"ckpt_{ADC_STEPS:07d}.npz"), dev)
    check(step == ADC_STEPS and int(state.alive.sum()) == ev[-1][4],
          f"checkpoint alive {int(state.alive.sum())}, last event N "
          f"{ev[-1][4]}")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()),
          "checkpoint params not finite")
    del state
    eval_grows = len(re.findall(r"eval view .* -> growing", text))
    check(len(rec["evals"]) == 1, f"{len(rec['evals'])} evaluations")
    eval_launches = {k: sum(e[1][k] for e in rec["evals"])
                     for k in adc_launches}
    renders = 2 * len(rec["evals"]) + eval_grows
    check_launches(eval_launches, ("expand", "align_copy", "composite_fwd"),
                   renders, "eval renders")
    adc_launches = executed(
        {k: adc_launches[k] - eval_launches[k] for k in adc_launches},
        SORTED_PATH, *rec["graph"])
    check_launches(adc_launches, SORTED_PATH, ADC_STEPS, "ADC steps")
    adc_launches = {k: adc_launches[k] + eval_launches[k]
                    for k in adc_launches}
    for res, _ in rec["evals"]:
        check(len(res.images) == 2 and all(
            math.isfinite(r.psnr) and math.isfinite(r.ssim)
            for r in res.images), "eval: not 2 finite views")
    eval_ms = [r.render_ms for res, _ in rec["evals"] for r in res.images]

    tr, first = rec["trainer"], rec["first"]
    images = tr._image_bank()
    args = (images[0], tr._viewmats[0], tr._intrinsics[0],
            torch.tensor(100.0), 0)
    adc_step = make_train_step(tr.cfg, tr.raster, tr.scene_extent)
    none_step = make_train_step(dataclasses.replace(
        tr.cfg, densify_mode="none"), tr.raster, tr.scene_extent)
    step_ms = [cuda_ms(lambda: adc_step(st, *args), reps=5, warmup=1)
               for st in (first[0], tr.state)]
    syncs = []
    for fn in (adc_step, none_step):
        fn(tr.state, *args)
        torch.cuda.synchronize()
        syncs.append(sync_warnings(lambda: fn(tr.state, *args)))
    check(len(syncs[0]) == len(syncs[1]), f"sync warnings: ADC step "
          f"{syncs[0]}, none step {syncs[1]}")
    densify = make_densify_step(tr.cfg, tr.scene_extent)
    event_syncs = sync_warnings(lambda: densify(
        tr.state, size_pruning_active=True))
    check(not event_syncs, f"a densify event synchronised: {event_syncs}")
    torch.cuda.synchronize()
    event_on_card_and_cpu(dev, "densify", tr, first)
    print(f"ADC train CLI ({card}): {rec['its']:.2f} it/s over {ADC_STEPS} "
          f"steps; N {rec['n0']} -> {ev[-1][4]}; events {ev}; densify "
          f"event ms at Nc {DENSIFY_CAPACITY} {rec['events_ms']} (mean "
          f"{np.mean(rec['events_ms']):.3f}); alive gaussians below the "
          f"opacity threshold, past 20 px, past 0.1 extent at each event "
          f"{rec['prune_causes']}; ADC step ms at N "
          f"{rec['n0']} (before the first event) {step_ms[0]:.3f}, at N "
          f"{ev[-1][4]} (after the last) {step_ms[1]:.3f}; eval ms per view "
          f"{[round(x, 3) for x in eval_ms]} ({eval_grows} regrows); graph: "
          f"{rec['graph'][1]} of the steps replays, {rec['graph'][0]} "
          f"captures ({', '.join(f'{x:.3f}' for x in rec['capture_s'])} s), "
          f"pool {rec['pool_bytes']} B, peak {rec['peak_gib']:.3f} GiB; sync "
          f"warnings: ADC step {len(syncs[0])}, none step {len(syncs[1])} "
          f"({syncs[1]}), densify event {len(event_syncs)}; losses {[round(x, 5) for x in rec['losses']]}; "
          f"launches {adc_launches} (eval {eval_launches})", flush=True)
    del tr, first, rec, adc_step, none_step, densify, images, args

    # MCMC.
    text, mcmc_launches, rec = run_train_cli(
        tmp, ds, "mcmc", MCMC_CONFIG, MCMC_STEPS, ["--mcmc"])
    ev = [tuple(map(int, m)) for m in re.findall(
        r"\[(\d+)\] mcmc relocate: (\d+) of (\d+) dead, \+(\d+) grown "
        r"\(N=(\d+)\)", text)]
    check([e[0] for e in ev] == [20, 40, 60, 80],
          f"relocate events at {[e[0] for e in ev]}")
    check(any(e[1] > 0 for e in ev), "no event relocated")
    grow_factor = rec["trainer"].cfg.mcmc.grow_factor
    n_alive = rec["n0"]
    for e in ev:
        want = int(np.float32(grow_factor) * np.float32(n_alive))
        check(e[3] == want and e[4] == n_alive + want,
              f"event {e}: grew {e[3]}, expected {want} of N {n_alive}")
        n_alive = e[4]
    mcmc_launches = executed(mcmc_launches, SORTED_PATH, *rec["graph"])
    check_launches(mcmc_launches, SORTED_PATH, MCMC_STEPS, "MCMC steps")
    tr = rec["trainer"]
    # The first event, and the last (the first may find no dead gaussian).
    for which in ("first", "last"):
        event_on_card_and_cpu(dev, "relocate", tr, rec[which])
    reloc = make_relocate_step(tr.cfg, tr.scene_extent)
    event_syncs = sync_warnings(lambda: reloc(tr.state))
    check(not event_syncs, f"a relocate event synchronised: {event_syncs}")
    print(f"MCMC train CLI ({card}): {rec['its']:.2f} it/s over "
          f"{MCMC_STEPS} steps; N {rec['n0']} -> {ev[-1][4]}; events {ev}; "
          f"relocate event ms at Nc {DENSIFY_CAPACITY} {rec['events_ms']} "
          f"(mean {np.mean(rec['events_ms']):.3f}); graph: {rec['graph'][1]} "
          f"of the steps replays, {rec['graph'][0]} captures, pool "
          f"{rec['pool_bytes']} B, peak {rec['peak_gib']:.3f} GiB; relocate "
          f"event syncs "
          f"{len(event_syncs)}; losses {[round(x, 5) for x in rec['losses']]}; "
          f"launches {mcmc_launches}", flush=True)
    return adc_launches, eval_launches, mcmc_launches


def viewer_camera(base, az_deg: float, w: int = CLI_W, h: int = CLI_H):
    """The render CLI's frame-0 camera (its orbit of the scene, `base` =
    OrbitCamera.from_points(means), at 15 degrees elevation) turned az_deg
    about the target with OrbitCamera.rotate, at w x h."""
    import dataclasses

    import numpy as np

    cam = dataclasses.replace(base, elevation=np.radians(15.0))
    cam.rotate(np.radians(az_deg), 0.0)
    return cam.build_camera(w, h)


def psnr(a, b) -> float:
    return -10.0 * math.log10(max(float(((a - b) ** 2).mean()), 1e-12))


def phase_viewer(dev, params):
    """The viewer's cached path on the render CLI's scene; returns the
    launches of the anchor build and of the drag."""
    import numpy as np
    import torch

    from tpugs_torch.core import transforms as tf
    from tpugs_torch.ops.render import render
    from tpugs_torch.ops.render_cached import build_frame_cache, render_cached
    from tpugs_torch.viewer.camera import OrbitCamera
    from tpugs_torch.viewer.offline import OfflineRenderer

    base = OrbitCamera.from_points(params["means"])
    r = OfflineRenderer(params, device=dev)  # the viewer's defaults
    for deg in (0.0, max(VIEWER_PSNR_DEG)):  # settle the capacities
        r.render_camera(viewer_camera(base, deg))
    cfg = r._cfg(CLI_H, CLI_W)
    p = r.params
    scene = (p["means"], p["quats"], p["log_scales"], p["opacity_logits"],
             p["sh"], r.alive)
    bg = torch.zeros(3, device=dev)

    def view(deg):
        cam = viewer_camera(base, deg)
        return (torch.as_tensor(cam.world_to_camera(), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(cam.intrinsics_array(), device=dev))

    def exact(vm, it):
        out = render(*scene, vm, it, cfg, r.sh_degree, bg, presort="qkey",
                     need_grads=False)
        check(not bool(out.pair_overflow) and not bool(out.hit_overflow),
              "exact viewer frame overflowed")
        return out

    vm0, it = view(0.0)
    # 1. The anchor build, and the cached frame at zero delta.
    reset_launches()
    cache = build_frame_cache(*scene, vm0, it, cfg, r.sh_degree)
    torch.cuda.synchronize()
    anchor_launches = read_launches()
    check_launches(anchor_launches, ("expand", "align_copy"), 1,
                   "anchor builds")
    ref = exact(vm0, it)
    for f in ("num_pairs", "pair_overflow", "max_tile_hits"):
        check(int(getattr(cache, f)) == int(getattr(ref, f)),
              f"anchor {f} {int(getattr(cache, f))} != render's "
              f"{int(getattr(ref, f))}")
    reset_launches()
    color, final_t = without_sync(
        lambda: render_cached(cache, vm0, it, cfg, bg), "render_cached")
    torch.cuda.synchronize()
    check_launches(read_launches(), ("composite_fwd",), 1, "cached frames")
    # The projection's first op per gaussian and per gathered slot: the
    # same bits whatever the row count (transforms._WorldToCamera).
    idx = torch.randint(0, p["means"].shape[0],
                        (cache.static_attr.shape[1],), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    t_slots = tf.world_to_camera_points(p["means"][idx], vm0)
    t_all = tf.world_to_camera_points(p["means"], vm0)[idx]
    differ = int((t_slots != t_all).sum())
    d_color = float((color - ref.color).abs().max())
    print(f"viewer anchor: {int(cache.num_pairs)} pairs, busiest tile "
          f"{int(cache.max_tile_hits)}, table {tuple(cache.static_attr.shape)}"
          f" (capacity {cfg.pair_capacity}, max hits {cfg.max_hits_per_tile});"
          f" launches {anchor_launches}; zero-delta cached frame vs "
          f"render(qkey): max |dC| {d_color}, max |dT| "
          f"{float((final_t - ref.final_T).abs().max())}; world_to_camera "
          f"per gaussian vs per slot: {differ} of {t_slots.numel()} values "
          f"differ", flush=True)
    check(torch.equal(color, ref.color) and torch.equal(final_t, ref.final_T),
          "the zero-delta cached frame is not render(presort='qkey')'s")
    check(differ == 0, "world_to_camera_points depends on the row count")

    # 2. The drag through render_interactive.
    r._icache = None
    drag_launches = collections.Counter()
    anchor_deg, paths = 0.0, []
    n0 = len(r.frame_stats)
    for i in range(VIEWER_DRAG_FRAMES):
        deg = i * VIEWER_STEP_DEG
        cam = viewer_camera(base, deg)
        reset_launches()
        r.render_interactive(CLI_H, CLI_W, cam.world_to_camera(),
                             cam.intrinsics_array(), (0.0, 0.0, 0.0))
        launches = read_launches()
        drag_launches.update(launches)
        path = r.frame_stats[-1].path
        paths.append(path)
        if path == "anchor":
            check(i == 0 or deg - anchor_deg >= 0.25 - 0.01,
                  f"drag frame {i} re-anchored {deg - anchor_deg:.3f} deg "
                  f"from its anchor")
            check_launches(launches, ("expand", "align_copy", "composite_fwd"),
                           1, "re-anchoring drag frames")
            anchor_deg = deg
        else:
            check(deg - anchor_deg <= 0.25 + 0.01,
                  f"drag frame {i} kept an anchor {deg - anchor_deg:.3f} deg "
                  f"away")
            check_launches(launches, ("composite_fwd",), 1, "cached drag frames")
    check(paths.count("anchor") >= 2, f"the drag never re-anchored: {paths}")
    drag = r.frame_stats[n0:]
    by_path = {k: [s.ms for s in drag if s.path == k] for k in ("anchor",
                                                                 "cached")}
    print(f"viewer drag {VIEWER_DRAG_FRAMES} frames x {VIEWER_STEP_DEG} deg: "
          f"{''.join('A' if x == 'anchor' else 'c' for x in paths)}; frame ms "
          f"{[round(s.ms, 3) for s in drag]}; mean anchor frame "
          f"{np.mean(by_path['anchor'][1:] or by_path['anchor']):.3f} ms, "
          f"mean cached frame {np.mean(by_path['cached']):.3f} ms; launches "
          f"{dict(drag_launches)}", flush=True)

    # 3. Drift against the exact frame.
    psnrs = []
    for deg in VIEWER_PSNR_DEG:
        vm, _ = view(deg)
        psnrs.append(psnr(render_cached(cache, vm, it, cfg, bg)[0],
                          exact(vm, it).color))
    print(f"viewer cached vs exact PSNR at {VIEWER_PSNR_DEG} deg from the "
          f"anchor: {[round(x, 3) for x in psnrs]} dB", flush=True)
    check(all(a > b for a, b in zip(psnrs, psnrs[1:])),
          f"PSNR does not fall with the angle: {psnrs}")

    # 4. Times (CUDA events).
    cam1 = viewer_camera(base, VIEWER_STEP_DEG)
    vm1, _ = view(VIEWER_STEP_DEG)
    n0 = len(r.frame_stats)
    for _ in range(6):
        r.render_arrays(CLI_H, CLI_W, cam1.world_to_camera(),
                        cam1.intrinsics_array(), (0.0, 0.0, 0.0))
    exact_ms = np.mean([s.ms for s in r.frame_stats[n0 + 1:]])
    anchor_ms = cuda_ms(lambda: build_frame_cache(*scene, vm0, it, cfg,
                                                  r.sh_degree))
    cached_ms = cuda_ms(lambda: render_cached(cache, vm1, it, cfg, bg))
    r.reanchor_frames, r._icache = VIEWER_REANCHOR_EVERY, None
    n0 = len(r.frame_stats)
    for i in range(3 * VIEWER_REANCHOR_EVERY):  # 0.01 deg steps: frames rule
        cam = viewer_camera(base, 0.01 * (i % VIEWER_REANCHOR_EVERY))
        r.render_interactive(CLI_H, CLI_W, cam.world_to_camera(),
                             cam.intrinsics_array(), (0.0, 0.0, 0.0))
    r.reanchor_frames = 0
    cycle = r.frame_stats[n0 + VIEWER_REANCHOR_EVERY:]
    check([s.path for s in cycle] == (["anchor"] + ["cached"] * (
        VIEWER_REANCHOR_EVERY - 1)) * 2, "re-anchor every 8 frames")
    every8_ms = np.mean([s.ms for s in cycle])
    print(f"viewer times 1920x1080 1M SH3 tile 32: exact frame "
          f"{exact_ms:.3f} ms (render_arrays), anchor build {anchor_ms:.3f} "
          f"ms, cached frame {cached_ms:.3f} ms, frame with a re-anchor every "
          f"{VIEWER_REANCHOR_EVERY} {every8_ms:.3f} ms (render_interactive; "
          f"(anchor + {VIEWER_REANCHOR_EVERY} cached) / "
          f"{VIEWER_REANCHOR_EVERY} = "
          f"{(anchor_ms + VIEWER_REANCHOR_EVERY * cached_ms) / VIEWER_REANCHOR_EVERY:.3f})",
          flush=True)
    del r, cache
    viewer_page_drag(dev, params, base)
    viewer_http(dev, params)
    return anchor_launches, dict(drag_launches)


def viewer_page_drag(dev, params, base):
    """Drags at the web page's rates (VIEWER_PAGE_PX) through
    render_interactive, at the render CLI's size and at the page's
    drag-frame size, each against the exact frame (render_arrays) of the
    same size, in a renderer of its own per size. Checks that a drag
    faster than the re-anchor angle re-anchors every frame (K1, K2 and K3
    once each)."""
    import numpy as np

    from tpugs_torch.viewer.offline import OfflineRenderer

    bg = (0.0, 0.0, 0.0)
    for w, h in ((CLI_W, CLI_H), (CLI_W // 2 - CLI_W // 2 % 32,
                                  CLI_H // 2 - CLI_H // 2 % 32)):
        r = OfflineRenderer(params, device=dev)  # tile 32, as the page's
        cam = viewer_camera(base, 0.0, w, h)
        for _ in range(7):  # the first grows the capacities
            r.render_arrays(h, w, cam.world_to_camera(),
                            cam.intrinsics_array(), bg)
        exact_ms = float(np.mean([s.ms for s in r.frame_stats[1:]]))
        rates = []
        for px in VIEWER_PAGE_PX:
            step = math.degrees(px * VIEWER_PAGE_RAD_PER_PX)
            r._icache = None
            n0 = len(r.frame_stats)
            for i in range(VIEWER_PAGE_FRAMES + 1):  # frame 0: the anchor
                cam = viewer_camera(base, i * step, w, h)
                reset_launches()
                r.render_interactive(h, w, cam.world_to_camera(),
                                     cam.intrinsics_array(), bg)
                launches = read_launches()
                if step > r.reanchor_deg:
                    check(r.frame_stats[-1].path == "anchor",
                          f"a {px} px drag frame {i} kept its anchor")
                    check_launches(launches, ("expand", "align_copy",
                                              "composite_fwd"), 1,
                                   "page-rate drag frames")
            drag = r.frame_stats[n0 + 1:]
            ms = float(np.mean([s.ms for s in drag]))
            pattern = "".join("A" if s.path == "anchor" else "c"
                              for s in drag)
            rates.append(f"{px} px ({step:.3f} deg) {pattern} {ms:.3f} ms "
                         f"({ms / exact_ms:.3f}x exact)")
        print(f"viewer page-rate drag {w}x{h} ({VIEWER_PAGE_FRAMES} frames "
              f"after the first anchor, mean ms a frame): exact frame "
              f"{exact_ms:.3f} ms; " + "; ".join(rates), flush=True)
        del r


def viewer_http(dev, params):
    """ViewerServer on a free port of 127.0.0.1, in a thread: the page,
    /info, four drag frames, a release, depth and heatmap over HTTP."""
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image

    from tpugs_torch.viewer.server import ViewerServer

    srv = ViewerServer(params, width=CLI_W, height=CLI_H, device=dev)
    http = srv.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{http.server_address[1]}"

    def call(path, req=None):
        body = None if req is None else json.dumps(req).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(base + path, body),
                                    timeout=120) as resp:
            check(resp.status == 200, f"{path} answered {resp.status}")
            return resp.read(), (time.perf_counter() - t0) * 1e3

    snap = lambda v: v - v % srv.renderer.tile  # noqa: E731
    try:
        page, _ = call("/")
        check(b"/render" in page, "the page does not post to /render")
        info = json.loads(call("/info")[0])
        check(info["num_gaussians"] == CLI_N and info["max_sh_degree"] == 3,
              f"/info {info}")
        reqs = [({"scale": 2, "azimuth": 0.002 * i}, 2) for i in range(4)]
        reqs += [({"azimuth": 0.006}, 1), ({"azimuth": 0.006, "mode": "depth"},
                                           1),
                 ({"azimuth": 0.006, "mode": "heatmap"}, 1)]
        times = []
        for req, scale in reqs:
            jpg, ms = call("/render", req)
            img = np.asarray(Image.open(io.BytesIO(jpg)))
            want = (snap(CLI_H // scale), snap(CLI_W // scale), 3)
            check(img.shape == want, f"{req}: JPEG {img.shape}, want {want}")
            times.append(round(ms, 1))
        paths = [s.path for s in srv.renderer.frame_stats]
        print(f"viewer http: GET / and /info, 7 frames {[r for r, _ in reqs]}"
              f" -> JPEGs at the snapped sizes; round trips ms {times}; "
              f"renderer paths {paths}", flush=True)
        check(paths[-3:] == ["exact"] * 3 and "cached" in paths,
              f"renderer paths {paths}")
    finally:
        http.shutdown()
        http.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the viewer server did not stop")


def phase_tools(tmp, dev):
    """info, dump_points, the native parse and --trace-dir on the card."""
    import numpy as np
    import torch

    from tpugs_torch.apps import dump_points, train as train_app
    from tpugs_torch.data import colmap, native

    proc = subprocess.run([sys.executable, "-m", "tpugs_torch.apps.info",
                           "--json"], capture_output=True, text=True,
                          timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"info exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    info = json.loads(proc.stdout)
    check(info["devices"][0]["name"] == torch.cuda.get_device_name(0)
          and info["render_ok"] and info["matmul_ok"], f"info: {info}")

    ds = os.path.join(tmp, "gt_scene")
    ply = os.path.join(tmp, "points.ply")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dump_points.main(["-d", ds, "-o", ply, "--device", dev.type])
    check(rc == 0, f"dump_points returned {rc}")
    with open(ply, "rb") as f:
        head = f.read(200)
    m = re.search(rb"element vertex (\d+)", head)
    check(m is not None and int(m.group(1)) == TRAIN_N + TRAIN_CLI_VIEWS,
          f"dump_points header {head[:80]!r}")

    pts = os.path.join(ds, "sparse", "0", "points3D.bin")
    t0 = time.perf_counter()
    xyz_n, rgb_n = native.parse_points3d(pts)
    native_s = time.perf_counter() - t0
    colmap.USE_NATIVE = False
    try:
        t0 = time.perf_counter()
        xyz_p, rgb_p = colmap.parse_points3d_bin(pts)
        numpy_s = time.perf_counter() - t0
    finally:
        colmap.USE_NATIVE = True
    check(np.array_equal(xyz_n, xyz_p) and np.array_equal(rgb_n, rgb_p),
          "the native parse of points3D.bin differs from the numpy parse")

    trace_dir = os.path.join(tmp, "trace")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = train_app.main([
            "-d", os.path.join(tmp, "gt_densify"), "-o",
            os.path.join(tmp, "trace_out"), "-i", str(TRACE_STEPS),
            "--no-densify", "--sh-degree", "3", "--log-every", "1",
            "--save-every", "0", "--max-hits", str(TRAIN_MAX_HITS),
            "--trace-dir", trace_dir, "--device", dev.type])
    trace_s = time.perf_counter() - t0
    check(rc == 0, f"train CLI with --trace-dir returned {rc}")
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    check(len(traces) == 1 and os.path.getsize(traces[0]) > 0,
          f"trace files {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    traced = collections.Counter(
        k for e in kernels for k in PORT_KERNEL_NAMES if k in e["name"])
    print(f"tools: info names {info['devices'][0]['name']} "
          f"({info['devices'][0]['memory_mb']:.0f} MB, sm "
          f"{info['devices'][0]['capability']}); dump_points {m.group(1).decode()}"
          f" vertices; points3D.bin of {len(xyz_n)} points parsed natively "
          f"in {native_s:.3f} s, numpy {numpy_s:.3f} s, equal; train CLI "
          f"{TRACE_STEPS} steps under --trace-dir in {trace_s:.1f} s: "
          f"{os.path.getsize(traces[0])} bytes, {len(events)} events, "
          f"{len(kernels)} kernel events; the port's kernels traced "
          f"{dict(traced)}", flush=True)


# Phase oracles: the scan oracle on phase 2's scene, the dense oracle on a
# tiny one.
ORACLE_W, ORACLE_H, ORACLE_N = 256, 192, 20_000
DENSE_W, DENSE_H, DENSE_N = 64, 48, 300
ORACLE_RTOL, ORACLE_ATOL_REL = 1e-4, 2e-5  # the CPU tests' gradient bounds
DENSE_ATOL, DENSE_ATOL_REL = 2e-5, 3e-4  # dense -> scan, the tests' bounds


def oracles_pre_aligned(dev, errs, card):
    """(a) The pre-aligned path at the garden train frame: its layout
    against align_segments(bin_gaussians(...)), its image and gradients
    against the kernel route's, K3 and K4b launched once each and held
    against their plain versions on the inputs it gave them, both paths'
    forward + backward timed. Returns the pre frame's launches."""
    import torch

    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops import composite as C
    from tpugs_torch.ops import composite_t
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.rasterize_tiled import RasterConfig
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy

    w, h = TRAIN_W, TRAIN_H
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=32, tile_w=32,
                       pair_capacity=TRAIN_PAIR_CAPACITY,
                       max_hits_per_tile=TRAIN_MAX_HITS)
    params = garden_params(dev)
    n = params["means"].shape[0]
    with torch.no_grad():
        proj = project_gaussians(
            *[params[k] for k in NAMES],
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.eye(4, device=dev),
            torch.from_numpy(synthetic_intrinsics_numpy(w, h)).to(dev),
            w, h, 3)
        pal = C.p_aligned(cfg)
        a = B.bin_gaussians_aligned(proj, w, h, 32, 32, cfg.pair_capacity, pal)
        b = B.bin_gaussians(proj, w, h, 32, 32, cfg.pair_capacity)
        astart, astop, agauss, avalid = C.align_segments(
            b.tile_start, b.tile_stop, b.pair_gauss, pal)
    for name, x, y in (("tile_start", a.tile_start, astart),
                       ("tile_stop", a.tile_stop, astop),
                       ("pair_gauss", a.pair_gauss, agauss),
                       ("pair_valid", a.pair_valid, avalid)):
        check(torch.equal(x, y), f"bin_gaussians_aligned {name} differs from "
              f"align_segments(bin_gaussians(...))")
    pairs, valid = int(a.num_pairs), int(a.pair_valid.sum())
    del proj, b, astart, astop, agauss, avalid
    ref_g, _, ref_img = frame_grads(dev, params)
    with capturing(composite_t, "composite_forward") as k3, \
            capturing(composite_t, "composite_backward") as k4b:
        grads, launches, img = frame_grads(dev, params, pre=True)
    check_launches(launches, ("composite_fwd", "composite_bwd_entry"), 1,
                   "pre-aligned frames")
    err = float((img - ref_img).abs().max())
    check(err == 0.0, f"pre-aligned image differs from the kernel route's "
          f"by {err}")
    worst = compare_grads(grads, ref_g, "pre-aligned path")
    with torch.no_grad():
        got = composite_t.composite_forward(*k3[0])
        ref = composite_t.composite_forward_plain(*k3[0])
        k3_err, m_nc, m_kl = compare_compositor(got, ref)
        errs["composite_fwd"] = max(errs.get("composite_fwd", 0.0), k3_err)
        args = k4b[0]
        rows = composite_t.composite_backward(*args, transposed_out=False)
        plain = composite_t.composite_backward_plain(*args,
                                                     transposed_out=False)
        # The slots K4b writes, each tile's [start, stop), are the ones
        # that hold a pair.
        walked = a.pair_valid
        check(bool(torch.isfinite(rows[walked]).all()),
              "K4b output not finite on the pre-aligned frame")
        k4b_err = float((rows[walked] - plain[walked]).abs().max())
    check(k4b_err == 0.0, f"K4b differs from its plain version on the "
          f"pre-aligned frame by {k4b_err}")
    errs["composite_bwd_entry"] = max(errs.get("composite_bwd_entry", 0.0),
                                      k4b_err)
    pre_ms = cuda_ms(lambda: frame_grads(dev, params, pre=True), reps=3,
                     warmup=1)
    route_ms = cuda_ms(lambda: frame_grads(dev, params), reps=3, warmup=1)
    print(f"oracles (a) pre-aligned garden frame {w}x{h} {n}: {pairs} pairs, "
          f"{valid} in {pal} aligned slots, layout equal to "
          f"align_segments(bin_gaussians); image max abs err {err:.3g} "
          f"against the kernel route; gradients within the card rule of the "
          f"sorted path's on >= {worst:.6f} of elements; K3 max abs err "
          f"{k3_err:.3g} (n_contrib/k_last equal {m_nc:.6f}/{m_kl:.6f}), K4b "
          f"bit-identical to their plain versions; launches {launches}",
          flush=True)
    print(f"oracles (a) forward + backward: pre-aligned {pre_ms:.3f} ms, "
          f"kernel route {route_ms:.3f} ms (CUDA events, means of 3) on "
          f"{card}", flush=True)
    return launches


def oracles_fast_presort(dev, cli_params, card):
    """(b) render(presort="fast") at the render CLI's frame 0: its image
    against "exact" (max abs err, PSNR), the sorted pairs whose gaussian
    differs, ms per frame beside "exact" and "auto"; K1-K3 once. Returns
    the fast frame's launches."""
    import torch

    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.render import RasterConfig, render
    from tpugs_torch.viewer.camera import orbit_trajectory

    cfg = RasterConfig(img_h=CLI_H, img_w=CLI_W, tile_h=32, tile_w=32,
                       pair_capacity=CLI_PAIR_CAPACITY,
                       max_hits_per_tile=CLI_MAX_HITS)
    cam = orbit_trajectory(cli_params["means"], CLI_FRAMES, CLI_W, CLI_H)[0]
    p = params_from_numpy(cli_params, dev)
    n = p["means"].shape[0]
    view = (torch.ones(n, dtype=torch.bool, device=dev),
            torch.as_tensor(cam.world_to_camera(), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(cam.intrinsics_array(), device=dev))
    bg = torch.zeros(3, device=dev)

    def frame(presort):
        with torch.no_grad():
            out = render(*[p[k] for k in NAMES], *view, cfg, 3, bg,
                         presort=presort, need_grads=False)
        check(not bool(out.pair_overflow) and not bool(out.hit_overflow),
              f"presort={presort!r} frame overflowed")
        return out

    frame("fast")  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    fast = frame("fast")
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, ("expand", "align_copy", "composite_fwd"), 1,
                   "fast-presort frames")
    exact = frame("exact")
    err = float((fast.color - exact.color).abs().max())
    db = psnr(fast.color, exact.color)
    check(bool(torch.isfinite(fast.color).all()), "fast frame not finite")
    check(int(fast.num_pairs) == int(exact.num_pairs), "fast frame pairs")
    with torch.no_grad():
        proj = project_gaussians(*[p[k] for k in NAMES], *view, CLI_W,
                                 CLI_H, 3)
        ids = []
        for quant in (0, 12):
            perm, pr = B.presort_by_depth(proj, quant_bits=quant)
            bb = B.bin_gaussians_expand_kernel(pr, CLI_W, CLI_H, 32, 32,
                                               cfg.pair_capacity,
                                               presorted=True)
            ids.append((perm[bb.pair_gauss.long()], bb))
        (ge, be), (gf, bf) = ids
        check(torch.equal(be.tile_start, bf.tile_start)
              and torch.equal(be.tile_stop, bf.tile_stop),
              "fast and exact presorts bin different pairs per tile")
        valid = be.pair_tile < cfg.num_tiles
        moved = int(((ge != gf) & valid).sum())
    fast_ms = cuda_ms(lambda: frame("fast"), reps=5, warmup=1)
    exact_ms = cuda_ms(lambda: frame("exact"), reps=5, warmup=1)
    auto_ms = cuda_ms(lambda: frame("auto"), reps=5, warmup=1)
    print(f"oracles (b) presort='fast' {CLI_W}x{CLI_H} {n} SH3: image against "
          f"'exact' max abs err {err:.4g}, PSNR {db:.3f} dB; {moved} of "
          f"{int(valid.sum())} sorted pairs hold another gaussian; launches "
          f"{launches}", flush=True)
    print(f"oracles (b) ms per frame: fast {fast_ms:.3f}, exact "
          f"{exact_ms:.3f}, auto {auto_ms:.3f} (CUDA events, 5 frames) on "
          f"{card}", flush=True)
    return launches


def _small_frame(p, dev, w, h, tile, compositor, target, dense=False):
    """Image and loss gradients of one small frame (SH 3, identity camera)
    through render(compositor=...), or through the dense oracle."""
    import torch

    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.rasterize_ref import render_reference
    from tpugs_torch.ops.render import RasterConfig, render
    from tpugs_torch.train.loss import combined_loss
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy

    cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                       pair_capacity=SMALL_PAIR_CAPACITY,
                       max_hits_per_tile=1 << 20)
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, dev).items()}
    n = tp["means"].shape[0]
    view = (torch.ones(n, dtype=torch.bool, device=dev),
            torch.eye(4, device=dev),
            torch.from_numpy(synthetic_intrinsics_numpy(w, h)).to(dev))
    bg = torch.zeros(3, device=dev)
    if dense:
        proj = project_gaussians(*[tp[k] for k in NAMES], *view, w, h, 3)
        color, _, nc = render_reference(proj, h, w, bg, tile, tile)
    else:
        out = render(*[tp[k] for k in NAMES], *view, cfg, 3, bg,
                     compositor=compositor)
        color, nc = out.color, out.n_contrib
    grads = torch.autograd.grad(
        combined_loss(color, torch.from_numpy(target).to(dev)),
        [tp[k] for k in NAMES])
    return color.detach(), nc, grads


def _grads_within(got, ref, rtol, atol_rel, what):
    """Every element of every group within rtol |ref| + atol_rel max|ref|
    (the CPU tests' rule); returns the worst group's largest error over
    its bound."""
    import torch

    worst = 0.0
    for name, a, b in zip(NAMES, got, ref):
        a, b = a.cpu(), b.cpu()
        check(bool(torch.isfinite(a).all()), f"{what}: d {name} not finite")
        tol = rtol * b.abs() + atol_rel * float(b.abs().max())
        ratio = float(((a - b).abs() / tol.clamp(min=1e-30)).max())
        check(ratio <= 1.0, f"{what}: d {name} off by {ratio:.3g} x its "
              f"bound")
        worst = max(worst, ratio)
    return worst


def oracles_scan(dev, card):
    """(c) render(compositor="scan") on phase 2's scene: image and
    gradients against the kernel route on the card and against the scan
    on the CPU; no kernel launched. Returns the scan frame's launches."""
    import numpy as np
    import torch

    from tpugs_torch.utils.synthetic import synthetic_params_numpy

    w, h, tile = ORACLE_W, ORACLE_H, 16
    p = synthetic_params_numpy(ORACLE_N, seed=0)
    target = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(
        np.float32)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    scan = _small_frame(p, dev, w, h, tile, "scan", target)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    check_launches(launches, (), 1, "scan frames")
    t0 = time.perf_counter()
    kern = _small_frame(p, dev, w, h, tile, "kernel", target)
    torch.cuda.synchronize()
    kern_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu = _small_frame(p, torch.device("cpu"), w, h, tile, "scan", target)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err_k = float((scan[0] - kern[0]).abs().max())
    err_c = float((scan[0].cpu() - cpu[0]).abs().max())
    check(err_k <= ATOL and err_c <= ATOL, f"scan image against the kernel "
          f"route {err_k}, against the CPU scan {err_c} (> {ATOL})")
    nc_k = float((scan[1] == kern[1]).float().mean())
    check(nc_k >= MIN_MATCH, f"scan n_contrib equal to the kernel route's "
          f"on {nc_k}")
    ratio = _grads_within(scan[2], kern[2], ORACLE_RTOL, ORACLE_ATOL_REL,
                          "scan against the kernel route")
    shares = [close_share(a.cpu(), b) for a, b in zip(scan[2], cpu[2])]
    check(min(shares) >= MIN_GRAD_MATCH, f"scan gradients card vs CPU "
          f"within the card rule on only {shares}")
    print(f"oracles (c) scan {w}x{h} {ORACLE_N} SH3 tile {tile}: image "
          f"against the "
          f"kernel route max abs err {err_k:.3g} (n_contrib equal "
          f"{nc_k:.6f}), against the CPU scan {err_c:.3g}; gradients within "
          f"the tests' bound of the kernel route's (worst {ratio:.3f} of "
          f"it), within the card rule of the CPU's on >= {min(shares):.6f}; "
          f"no kernel launched", flush=True)
    print(f"oracles (c) forward + backward: scan {scan_ms:.1f} ms, kernel "
          f"route {kern_ms:.1f} ms on {card}; scan on the CPU {cpu_ms:.1f} "
          f"ms (first calls, host clock)", flush=True)
    return launches


def oracles_dense(dev, card):
    """(d) composite_dense on a tiny scene against the scan, on the card:
    image, n_contrib and gradients at the tests' chain bounds."""
    import numpy as np
    import torch

    from tpugs_torch.utils.synthetic import synthetic_params_numpy

    w, h = DENSE_W, DENSE_H
    p = synthetic_params_numpy(DENSE_N, seed=3, scale_range=(0.03, 0.2))
    target = np.random.default_rng(2).uniform(0, 1, (h, w, 3)).astype(
        np.float32)
    t0 = time.perf_counter()
    dense = _small_frame(p, dev, w, h, 16, None, target, dense=True)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    scan = _small_frame(p, dev, w, h, 16, "scan", target)
    err = float((dense[0] - scan[0]).abs().max())
    check(err <= DENSE_ATOL, f"dense oracle against the scan: {err}")
    check(torch.equal(dense[1], scan[1]), "dense n_contrib differs")
    check(int(dense[1].max()) > 1, "dense scene composites nothing twice")
    ratio = _grads_within(scan[2], dense[2], 0.0, DENSE_ATOL_REL,
                          "scan against the dense oracle")
    print(f"oracles (d) dense {w}x{h} {DENSE_N} SH3: image against the scan "
          f"max abs err {err:.3g}, n_contrib equal (max "
          f"{int(dense[1].max())}), gradients within the tests' bound (worst "
          f"{ratio:.3f} of it); dense {dense_ms:.1f} ms on {card}",
          flush=True)


def phase_oracles(dev, cli_params, errs, card):
    """The oracles and the variants that only they reach: (a)-(d) above.
    Returns the launches of the pre-aligned, fast-presort and scan
    frames."""
    pre = oracles_pre_aligned(dev, errs, card)
    fast = oracles_fast_presort(dev, cli_params, card)
    scan = oracles_scan(dev, card)
    oracles_dense(dev, card)
    return pre, fast, scan


MESH_STEPS = 4  # timed steps after step 0, per mesh configuration
MESH_CLI_STEPS = 8
ULP2 = 5e-7  # mesh colour against the single-device render (tpugs' bound)
MESH_RANK_TIMEOUT_S = 240


def mesh_scene(dev):
    """The garden frame of phase train-step: (raster config, whole train
    state, viewmat, intrinsics, target)."""
    import torch

    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import TrainState, initial_key
    from tpugs_torch.utils.synthetic import synthetic_intrinsics_numpy

    w, h = TRAIN_W, TRAIN_H
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=32, tile_w=32,
                       pair_capacity=TRAIN_PAIR_CAPACITY,
                       max_hits_per_tile=TRAIN_MAX_HITS)
    params = garden_params(dev)
    state = TrainState(params=params,
                       alive=torch.ones(TRAIN_N, dtype=torch.bool,
                                        device=dev),
                       adam=adam_init(params), adc=adc_init(TRAIN_N, dev),
                       key=initial_key(0))
    intr = torch.from_numpy(synthetic_intrinsics_numpy(w, h)).to(dev)
    target = torch.rand((h, w, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    return cfg, state, torch.eye(4, device=dev), intr, target


def timed_steps(step_fn, state, target, viewmat, intr, first: int,
                steps: int):
    """steps train steps from step `first`, each timed with CUDA events:
    (state, ms per step, losses); every step's loss finite, no overflow."""
    import torch

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms, losses = [], []
    for i in range(first, first + steps):
        ev0.record()
        state, stats = step_fn(state, target, viewmat, intr,
                               torch.tensor(float(i)), 3)
        ev1.record()
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1))
        losses.append(float(stats.loss))
        check(math.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}")
        check(not bool(stats.pair_overflow) and not bool(stats.hit_overflow)
              and not bool(stats.send_overflow is not None
                           and stats.send_overflow),
              f"step {i} overflowed")
    return state, ms, losses


def mesh_check(mesh, dev, errs, where: str, kernel_rows: bool):
    """One rank's part of phase mesh at the garden shape: the assembled
    image against the single-device render (ULP2), step 0 of
    dist_train.make_dist_train_step (the exchange capacity auto-tuned as
    the Trainer tunes it) with its normalised gradient (Adam's first moment
    after one step) against the single-device step's on this shard's rows
    (the card-vs-CPU rule), then MESH_STEPS timed steps, each through the
    sorted path's five kernels. kernel_rows: step 0's kernels held against
    their plain versions and timed (forward_kernel_rows,
    backward_kernel_rows). Returns this rank's numbers."""
    import numpy as np
    import torch

    from tpugs_torch.ops import composite_t, expand, pack, segreduce
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.render import render
    from tpugs_torch.parallel import dist_train as DT
    from tpugs_torch.parallel import tile_shard as TS
    from tpugs_torch.train.trainer import TrainConfig, make_train_step

    cfg, whole, viewmat, intr, target = mesh_scene(dev)
    state = DT.shard_train_state(mesh, whole)
    n_loc = state.alive.shape[0]
    worst = DT.measure_max_send_count(mesh, cfg, state.params, state.alive,
                                      [viewmat.cpu().numpy()],
                                      [intr.cpu().numpy()])
    cap = DT.auto_send_capacity(worst, n_loc)
    g = mesh.gauss
    row_lo = mesh.gauss_index * TS.rows_per_device(cfg, g)
    local_cfg = TS.local_raster_config(
        cfg, g, TS.default_local_pair_capacity(cfg.pair_capacity, g))
    p = state.params
    with torch.no_grad():
        proj = project_gaussians(p["means"], p["quats"], p["log_scales"],
                                 p["opacity_logits"], p["sh"], state.alive,
                                 viewmat, intr, cfg.img_w, cfg.img_h, 3)
        color_t, _, _, diag = TS.exchange_and_render_local(
            proj, cfg, local_cfg, mesh, cap, torch.zeros(3, device=dev),
            need_grads=False)
        image = TS.assemble_image(cfg, mesh, color_t)
        w = whole.params
        single = render(w["means"], w["quats"], w["log_scales"],
                        w["opacity_logits"], w["sh"], whole.alive, viewmat,
                        intr, cfg, 3, torch.zeros(3, device=dev),
                        need_grads=False).color
    img_err = float((image - single).abs().max())
    check(img_err <= ULP2, f"{where}: assembled image differs from the "
          f"single-device render by {img_err}")
    report = TS.comm_report(cfg, g, TRAIN_N, cap, int(diag["max_send_count"]),
                            int(diag["num_pairs"]))

    step_fn = DT.make_dist_train_step(
        TrainConfig(densify_mode="none", dist_send_capacity=cap), cfg, mesh,
        1.0)
    torch.cuda.synchronize()
    reset_launches()
    with capturing(expand, "expand_pairs") as k1, \
            capturing(pack, "align_copy") as k2, \
            capturing(composite_t, "composite_forward") as k3, \
            capturing(composite_t, "composite_backward") as k4, \
            capturing(segreduce, "segment_sum_sorted") as k5, \
            capturing(segreduce, "sort_by_key") as srt:
        state, ms0, _ = timed_steps(step_fn, state, target, viewmat, intr,
                                    0, 1)
    m_mesh = {k: v.clone() for k, v in state.adam.m.items()}
    state, ms, losses = timed_steps(step_fn, state, target, viewmat, intr,
                                    1, MESH_STEPS)
    launches = read_launches()
    check_launches(launches, SORTED_PATH, 1 + MESH_STEPS, f"{where} steps")
    # K1 took the row-clipped slice; K3 and K4 its first tile row.
    itab = k1[0][0]
    owners = itab[1] > 0
    check(bool(owners.any()) and int(itab[3][owners].min()) >= row_lo
          and int((itab[3] + torch.div(itab[1], itab[4],
                                       rounding_mode="floor"))[owners].max())
          <= row_lo + TS.rows_per_device(cfg, g),
          f"{where}: K1's rects are not clipped to rows {row_lo}+")
    check(k3[0][4] == row_lo and k4[0][8] == row_lo,
          f"{where}: compositors at row_offset {k3[0][4]}, {k4[0][8]}, "
          f"not {row_lo}")
    single_fn = make_train_step(TrainConfig(densify_mode="none"), cfg, 1.0)
    one, _ = single_fn(whole, target, viewmat, intr, torch.tensor(0.0), 3)
    lo = mesh.gauss_index * n_loc
    shares = {k: close_share(m_mesh[k], one.adam.m[k][lo:lo + n_loc])
              for k in NAMES}
    check(min(shares.values()) >= MIN_GRAD_MATCH, f"{where}: normalised "
          f"gradients within tolerance of the single-device step's on only "
          f"{shares}")
    rows = []
    if kernel_rows:
        with torch.no_grad():
            rows = forward_kernel_rows(dev, k1[0], k2[0], k3[0], errs, where)
            rows += backward_kernel_rows(dev, k4[0], k5[0], srt[0], errs,
                                         where)
        print_rows(rows, where)
    return {"ms_step0": ms0[0], "ms": ms, "losses": losses,
            "launches": launches, "send_capacity": cap, "max_send": worst,
            "n_loc": n_loc, "a2a_bytes": report["all_to_all_bytes_per_device"],
            "color_bytes": report["color_all_gather_bytes"],
            "pairs": int(diag["num_pairs"]), "row_offset": row_lo,
            "img_err": img_err, "grad_share": min(shares.values())}


MESH_BLOCK_K = 10  # steps of each graphed mesh block in phase mesh (c)
MESH_GLOO_K = 4  # steps of the gloo ranks' eager block in (f)


def bench_50k_scene(dev):
    """bench-50k's frame as mesh_scene's tuple: (raster config, whole train
    state, viewmat, intrinsics, target)."""
    from tpugs_torch import bench
    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import TrainState, initial_key

    s = bench.PRIMARY
    w, h = s["img_w"], s["img_h"]
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=bench.TILE, tile_w=bench.TILE,
                       pair_capacity=s["pair_capacity"],
                       max_hits_per_tile=s["max_hits"])
    params, alive, vm, intr, _ = bench.bench_scene(w, h, s["n"], None, dev)
    state = TrainState(params=params, alive=alive, adam=adam_init(params),
                       adc=adc_init(s["n"], dev), key=initial_key(0))
    return cfg, state, vm, intr, bench.bench_target(w, h, dev)


def mesh_send_capacity(mesh, cfg, state, viewmat, intr) -> int:
    """The exchange capacity the Trainer auto-tunes for this view."""
    from tpugs_torch.parallel import dist_train as DT

    worst = DT.measure_max_send_count(mesh, cfg, state.params, state.alive,
                                      [viewmat.cpu().numpy()],
                                      [intr.cpu().numpy()])
    return DT.auto_send_capacity(worst, state.alive.shape[0])


def stats_diffs(a, b) -> list:
    """The StepStats fields of a that are not bit-equal to b's."""
    import dataclasses

    import torch

    return [f.name for f in dataclasses.fields(a)
            if getattr(a, f.name) is not None
            and not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def mesh_block(mesh, dev, label: str, mode: str, scene, launches_by,
               timed: bool):
    """make_dist_multi_step on a 1x1 mesh of an NCCL world (densify mode
    `mode`, at `scene`): a first block of MESH_BLOCK_K steps (2 eager
    steps, the capture, the rest replays) and a second one, all replays
    and profiled, each against as many eager make_dist_train_step steps
    from the same state: losses, the mesh statistics and every tensor of
    the state bit-equal; K1-K5 once per replayed step among the profile's
    kernel events. timed: the eager mesh step under sync debug mode
    "error", then ms per step of the graphed block, the eager mesh steps
    and the single-device graphed block (make_train_multi_step) in turns.
    Returns the numbers printed."""
    import numpy as np
    import torch

    from tpugs_torch.parallel import dist_train as DT
    from tpugs_torch.train.trainer import TrainConfig, make_train_multi_step

    k = MESH_BLOCK_K
    cfg, state0, vm, intr, target = scene
    check(DT.graph_capturable(mesh), f"{label}: the mesh is not capturable")
    cap = mesh_send_capacity(mesh, cfg, state0, vm, intr)
    tcfg = TrainConfig(densify_mode=mode, dist_send_capacity=cap)
    multi = DT.make_dist_multi_step(tcfg, cfg, mesh, 1.0)
    step = DT.make_dist_train_step(tcfg, cfg, mesh, 1.0)
    bank = (target[None], vm[None], intr[None])
    vi = np.zeros(k, np.int64)
    full = lambda v: torch.full((), float(v), device=dev)  # noqa: E731

    def eager(st, first):
        losses = []
        for j in range(k):
            st, stats = step(st, target, vm, intr, full(first + j), 3)
            losses.append(stats.loss)
        return st, torch.stack(losses), stats

    def held(got, ref, block: str):
        (s_g, l_g, st_g), (s_e, l_e, st_e) = got, ref
        diffs = state_diffs(s_g, s_e) + stats_diffs(st_g, st_e)
        check(torch.equal(l_g, l_e) and not diffs,
              f"{label} {mode} {block}: the graphed block differs from the "
              f"eager mesh steps (losses max diff "
              f"{float((l_g - l_e).abs().max())}; {diffs})")
        check(bool(torch.isfinite(l_g).all()) and not bool(st_g.pair_overflow)
              and not bool(st_g.send_overflow),
              f"{label} {mode} {block}: losses {l_g.tolist()}, overflow")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first = multi(state0, *bank, vi, 0, 3)
    float(first[1][-1])
    first_s = time.perf_counter() - t0
    runner = multi.graphed[dev].runner
    check(runner.captures == 1 and runner.replays == k - 2,
          f"{label} {mode}: {runner.captures} captures, {runner.replays} "
          f"replays in the first block")
    ref = eager(state0, 0)
    held(first, ref, "first block")
    second, counts, busy, wall, events = profiled(
        lambda: multi(first[0], *bank, vi, k, 3))
    launches_by[f"mesh_1x1_{label}_{mode}_block"] = counts
    check_launches(counts, SORTED_PATH, k,
                   f"{label} {mode} replayed mesh block steps (profiler)")
    ref = eager(ref[0], k)
    held(second, ref, "second block")
    out = {"capture_s": runner.capture_seconds[0],
           "pool_bytes": pool_bytes(runner), "busy_share": busy / wall,
           "busy_ms": busy, "wall_ms": wall, "first_s": first_s,
           "send_capacity": cap, "counts": counts,
           "losses": second[1].tolist()}
    if timed:
        st = ref[0]
        torch.cuda.synchronize()
        without_sync(lambda: step(st, target, vm, intr, full(2 * k), 3),
                     f"the eager mesh step ({label}, {mode})")
        single = make_train_multi_step(tcfg, cfg, 1.0)
        s1 = single(state0, *bank, vi, 0, 3)[0]
        times = {"graph": [], "eager": [], "single_graph": []}
        s_g = second[0]
        for _ in range(2):
            for way in times:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if way == "graph":
                    s_g, losses, _ = multi(s_g, *bank, vi, 0, 3)
                elif way == "eager":
                    _, losses, _ = eager(st, 0)
                else:
                    s1, losses, _ = single(s1, *bank, vi, 0, 3)
                float(losses[-1])
                times[way].append((time.perf_counter() - t0) * 1e3 / k)
        out["ms"] = times
        out["single_pool_bytes"] = pool_bytes(single.graphed[dev].runner)
        # Where the mesh step's extra device time goes: both replayed
        # blocks' busiest device operations, ms per step.
        _, _, s_busy, _, s_events = profiled(
            lambda: single(s1, *bank, vi, 0, 3))
        out["busy_ms_per_step"] = (busy / k, s_busy / k)
        out["top"] = (top_device_ops(events, k), top_device_ops(s_events, k))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def top_device_ops(events, per: int, n: int = 8) -> list:
    """The n device events of a profile with the most self device time, as
    (name cut to 48 characters, ms per `per`)."""
    attr = ("self_device_time_total"
            if events and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    top = sorted(events, key=lambda e: -getattr(e, attr))[:n]
    return [(e.key[:48], round(getattr(e, attr) / 1e3 / per, 3)) for e in top]


def nccl_capture_probe(dev, scene, cap: int) -> dict:
    """(d) NCCL inside a CUDA graph, on the world-1 NCCL group itself
    (parallel/comm.py skips collectives over an axis of size 1): each
    collective the mesh step runs, at the garden step's shapes and
    types (the exchange's all_to_all_single of f32 [G, cap, 12]; the colour
    tiles' all_gather_into_tensor of f32 and the statistics' of int64; the
    gradients' all_reduce SUM of f32, the radii's MAX of f32 and a count's
    MAX of int64), run eagerly on a side stream, captured, then replayed
    on new inputs: each replay's outputs equal the same collectives run
    eagerly on those inputs, and, over one rank, the inputs."""
    import torch
    import torch.distributed as dist

    from tpugs_torch.parallel import tile_shard as TS

    cfg, state = scene[:2]
    n = state.alive.shape[0]
    red = dist.ReduceOp
    shapes = {
        "all_to_all_f32": ((1, cap, TS.EXCHANGE_ATTRS), torch.float32),
        "all_gather_f32": ((cfg.num_tiles, cfg.pix, 3), torch.float32),
        "all_gather_i64": ((1, 5), torch.int64),
        "all_reduce_sum_f32": ((n * 61 + 2,), torch.float32),
        "all_reduce_max_f32": ((n,), torch.float32),
        "all_reduce_max_i64": ((1,), torch.int64),
    }
    gen = torch.Generator(device=dev).manual_seed(11)

    def draw(shape, dtype):
        if dtype == torch.int64:
            return torch.randint(0, 1 << 40, shape, dtype=dtype, device=dev,
                                 generator=gen)
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    ins = {k: draw(*v) for k, v in shapes.items()}
    outs = {k: torch.empty_like(v) for k, v in ins.items()}

    def collectives():
        dist.all_to_all_single(outs["all_to_all_f32"], ins["all_to_all_f32"])
        dist.all_gather_into_tensor(outs["all_gather_f32"],
                                    ins["all_gather_f32"])
        dist.all_gather_into_tensor(outs["all_gather_i64"],
                                    ins["all_gather_i64"])
        for name, op in (("all_reduce_sum_f32", red.SUM),
                         ("all_reduce_max_f32", red.MAX),
                         ("all_reduce_max_i64", red.MAX)):
            outs[name].copy_(ins[name])
            dist.all_reduce(outs[name], op=op)

    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        collectives()  # the eager warm-up the capture needs
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=side):
        collectives()
    capture_s = time.perf_counter() - t0
    results = {}
    for rep in range(2):
        for v in ins.values():
            v.copy_(draw(v.shape, v.dtype))
        collectives()
        want = {k: v.clone() for k, v in outs.items()}
        for v in outs.values():
            v.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for k in ins:
            ok = torch.equal(outs[k], want[k]) and torch.equal(
                outs[k], ins[k])
            check(ok, f"NCCL capture probe: replay {rep} of {k} differs "
                  f"from the eager collective")
            results[k] = ok
    return {"capture_s": capture_s, "bytes": sum(
        v.numel() * v.element_size() for v in ins.values()),
        "collectives": sorted(results)}


def gloo_block(mesh, dev) -> dict:
    """(f) make_dist_multi_step on this gloo rank for MESH_GLOO_K steps at
    the garden frame: the mesh cannot be captured, so the block runs its
    steps eagerly; its losses and state equal as many make_dist_train_step
    steps from the same state, bit for bit."""
    import numpy as np
    import torch

    from tpugs_torch.parallel import dist_train as DT
    from tpugs_torch.train.trainer import TrainConfig

    cfg, whole, vm, intr, target = mesh_scene(dev)
    state = DT.shard_train_state(mesh, whole)
    del whole
    cap = mesh_send_capacity(mesh, cfg, state, vm, intr)
    tcfg = TrainConfig(densify_mode="adc", dist_send_capacity=cap)
    check(not DT.graph_capturable(mesh), "a gloo mesh of 2 ranks reads as "
          "capturable")
    multi = DT.make_dist_multi_step(tcfg, cfg, mesh, 1.0)
    step = DT.make_dist_train_step(tcfg, cfg, mesh, 1.0)
    vi = np.zeros(MESH_GLOO_K, np.int64)
    got, losses, _ = multi(state, target[None], vm[None], intr[None], vi, 0, 3)
    check(not multi.graphed, "the gloo block took the graphed path")
    ref, ref_losses = state, []
    for j in range(MESH_GLOO_K):
        ref, st = step(ref, target, vm, intr, torch.tensor(float(j)), 3)
        ref_losses.append(st.loss)
    ref_losses = torch.stack(ref_losses)
    diffs = state_diffs(got, ref)
    check(torch.equal(losses, ref_losses) and not diffs,
          f"gloo block against its eager steps: {diffs}")
    return {"losses": losses.tolist(), "way": "eager (gloo)"}


def mesh_rank(rank: int, store: str, out: str):
    """Rank `rank` of phase mesh (b): a gloo world of two ranks on card 0,
    data=1,gauss=2 (NCCL refuses two ranks on one card); rank 1 holds its
    kernels against their plain versions. Writes rank<r>.json or
    rank<r>.err into `out`."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        from tpugs_torch.parallel.mesh import make_mesh

        mesh = make_mesh((1, 2), device=dev, backend="gloo")
        print(f"mesh rank {rank}: backend gloo named on {dev}: gloo takes "
              f"the card tensors of every collective through host memory",
              flush=True)
        errs = {}
        res = mesh_check(mesh, dev, errs, f"mesh 1x2 rank {rank}",
                         kernel_rows=rank == 1)
        res["block"] = gloo_block(mesh, dev)
        res["errs"] = errs
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_mesh(tmp, dev, errs):
    """(a) World size 1, NCCL, data=1,gauss=1 in this process: mesh_check
    against the single-device step, the single-device step timed beside the
    mesh step; then the train CLI under torchrun with --mesh
    data=1,gauss=1 on the densify dataset. (b) two gloo ranks on the card,
    data=1,gauss=2 (mesh_rank), the library built here first. Returns the
    launches of (a)'s and (b)'s mesh steps."""
    import datetime
    import multiprocessing as mp

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpugs_torch.parallel.mesh import make_mesh
    from tpugs_torch.train.trainer import TrainConfig, make_train_step

    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
        device_id=dev)
    block_launches = {}
    try:
        mesh = make_mesh((1, 1), device=dev)
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        a = mesh_check(mesh, dev, errs, "mesh 1x1", kernel_rows=False)
        # (c) the block through the graph; (d) NCCL inside a graph.
        garden = mesh_scene(dev)
        c = mesh_block(mesh, dev, "garden", "adc", garden, block_launches,
                       timed=True)
        c50 = mesh_block(mesh, dev, "50k", "mcmc", bench_50k_scene(dev),
                         block_launches, timed=False)
        d = nccl_capture_probe(dev, garden, c["send_capacity"])
        del garden
    finally:
        dist.destroy_process_group()
    cfg, whole, viewmat, intr, target = mesh_scene(dev)
    step_fn = make_train_step(TrainConfig(densify_mode="none"), cfg, 1.0)
    whole, _, _ = timed_steps(step_fn, whole, target, viewmat, intr, 0, 1)
    _, single_ms, _ = timed_steps(step_fn, whole, target, viewmat, intr, 1,
                                  MESH_STEPS)
    del whole
    print(f"mesh 1x1 (nccl, world 1): {float(np.median(a['ms'])):.3f} ms per "
          f"step (steps {', '.join(f'{m:.2f}' for m in a['ms'])}; step 0 "
          f"{a['ms_step0']:.1f}) against the single-device step "
          f"{float(np.median(single_ms)):.3f} ms (steps "
          f"{', '.join(f'{m:.2f}' for m in single_ms)}); image max abs err "
          f"{a['img_err']:.3g}; gradients within the card rule on "
          f"{a['grad_share']:.6f}; send capacity {a['send_capacity']} "
          f"(max send {a['max_send']}, N/G {a['n_loc']}), exchange "
          f"{a['a2a_bytes']} B per step, colour gather {a['color_bytes']} B; "
          f"launches {a['launches']}", flush=True)
    ms = c["ms"]
    print(f"mesh 1x1 (nccl, world 1) block: make_dist_multi_step through the "
          f"graph (graph_capturable: every axis of size 1, no collective "
          f"captured); garden ADC, 2 blocks of {MESH_BLOCK_K} bit-equal to "
          f"the eager mesh steps (losses, mesh stats, every tensor of the "
          f"state); first block {c['first_s']:.3f} s (2 eager steps, capture "
          f"{c['capture_s']:.3f} s, {MESH_BLOCK_K - 2} replays); replayed "
          f"block's kernels by profiler {c['counts']}; busy share "
          f"{c['busy_share']:.4f} ({c['busy_ms']:.3f} of {c['wall_ms']:.3f} "
          f"ms); ms per step in turns: mesh graph "
          f"{[round(x, 3) for x in ms['graph']]}, eager mesh "
          f"{[round(x, 3) for x in ms['eager']]}, single-device graph "
          f"{[round(x, 3) for x in ms['single_graph']]}; graph pool "
          f"{c['pool_bytes']} B (single-device {c['single_pool_bytes']} B); "
          f"peak allocated {c['peak_gib']:.3f} GiB; send capacity "
          f"{c['send_capacity']}; the eager mesh step raised nothing under "
          f"sync debug \"error\"", flush=True)
    print(f"mesh 1x1 block against the single-device graphed block, device "
          f"busy ms per step {c['busy_ms_per_step'][0]:.3f} against "
          f"{c['busy_ms_per_step'][1]:.3f}; top device ops (ms per step): "
          f"mesh {c['top'][0]}; single-device {c['top'][1]}", flush=True)
    print(f"mesh 1x1 (nccl, world 1) block: 50k MCMC through the graph, 2 "
          f"blocks of {MESH_BLOCK_K} bit-equal to the eager mesh steps (the "
          f"registered generator re-seeded per step from the key and the "
          f"shard); capture {c50['capture_s']:.3f} s, pool "
          f"{c50['pool_bytes']} B; kernels by profiler {c50['counts']}; busy "
          f"share {c50['busy_share']:.4f}", flush=True)
    print(f"mesh nccl capture probe (world-1 NCCL group): "
          f"{', '.join(d['collectives'])} captured in {d['capture_s']:.3f} s "
          f"and replayed twice on new inputs, equal to the eager "
          f"collectives ({d['bytes']} B of inputs)", flush=True)

    # (e) The train CLI under torchrun, world size 1, NCCL, through the
    # graphed block.
    ds = os.path.join(tmp, "gt_densify")
    out_dir = os.path.join(tmp, "mesh_cli_out")
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", os.path.abspath(__file__), "--mesh-cli",
           "-d", ds,
           "-o", out_dir, "-i", str(MESH_CLI_STEPS), "--no-densify",
           "--capacity", str(1 << 18), "--sh-degree", "3", "--log-every",
           "1", "--save-every", "0", "--max-hits", str(TRAIN_MAX_HITS),
           "--mesh", "data=1,gauss=1"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    cli_s = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        print(f"mesh cli: {line}", flush=True)
    check(run.returncode == 0, f"torchrun train CLI returned "
          f"{run.returncode}: {run.stderr[-2000:]}")
    check("backend nccl" in run.stdout and "mesh: data=1 gauss=1" in
          run.stdout, "the CLI did not run on an NCCL mesh")
    m = re.search(r"graph: captures (\d+) replays (\d+)", run.stdout)
    check(m is not None and int(m.group(1)) >= 1 and int(m.group(2)) >= 1,
          "the mesh CLI's steps did not run as graph replays")
    cli_captures, cli_replays = int(m.group(1)), int(m.group(2))
    hist = [json.loads(x) for x in open(os.path.join(out_dir,
                                                     "history.jsonl"))]
    check([r["step"] for r in hist] == list(range(MESH_CLI_STEPS))
          and all(math.isfinite(r["loss"]) for r in hist),
          f"mesh cli history {hist}")
    print(f"mesh cli: torchrun, {MESH_CLI_STEPS} steps in {cli_s:.1f} s "
          f"(process start, dataset, init included); {cli_replays} of the "
          f"steps graph replays ({cli_captures} captures)", flush=True)

    # (b) two ranks on the one card: the library is built (phase build).
    ctx = mp.get_context("spawn")
    out = os.path.join(tmp, "mesh_ranks")
    os.makedirs(out)
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, os.path.join(out, "store"), out))
             for r in range(2)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(max(1.0, MESH_RANK_TIMEOUT_S - (time.perf_counter() - t0)))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    for r in range(2):
        err = os.path.join(out, f"rank{r}.err")
        check(not os.path.exists(err), f"mesh rank {r} failed:\n"
              + (open(err).read() if os.path.exists(err) else ""))
    check(not hung, f"mesh ranks {hung} hung; killed")
    check([proc.exitcode for proc in procs] == [0, 0],
          f"mesh ranks exited {[proc.exitcode for proc in procs]}")
    b = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(2)]
    check(b[1]["row_offset"] > 0, "rank 1 composited at row offset 0")
    for name, e in b[1]["errs"].items():
        errs[name] = max(errs.get(name, 0.0), e)
    for r, res in enumerate(b):
        print(f"mesh 1x2 rank {r} (gloo, one card): "
              f"{float(np.median(res['ms'])):.3f} ms per step (steps "
              f"{', '.join(f'{m:.2f}' for m in res['ms'])}; step 0 "
              f"{res['ms_step0']:.1f}); row offset {res['row_offset']}; "
              f"pairs {res['pairs']}; image max abs err {res['img_err']:.3g}; "
              f"gradients within the card rule on {res['grad_share']:.6f}; "
              f"send capacity {res['send_capacity']} (max send "
              f"{res['max_send']}, N/G {res['n_loc']}), exchange "
              f"{res['a2a_bytes']} B per step, colour gather "
              f"{res['color_bytes']} B; launches {res['launches']}; "
              f"make_dist_multi_step ran {MESH_GLOO_K} steps {res['block']['way']}"
              f" (graph_capturable false on gloo), losses "
              f"{[round(x, 6) for x in res['block']['losses']]} equal to its "
              f"eager steps", flush=True)
    print(f"mesh: ranks (b) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return a["launches"], b[0]["launches"], b[1]["launches"], block_launches


def bound(nbytes: int, ops: int):
    """(least ms for this work on the card, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def print_rows(rows, where: str):
    for r in rows:
        bound_ms, bound_by = bound(r.nbytes, r.ops)
        lib = "n/a" if r.lib_ms is None else f"{r.lib_ms:.4f} ms ({r.lib})"
        print(f"{where} {r.name}: {r.ms:.4f} ms as called, {r.alone_ms:.4f} "
              f"ms alone, bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{r.plain_ms:.2f} ms, library {lib}"
              + "".join(f", {k} {v:.4f}" for k, v in (r.extra or {}).items()
                        if isinstance(v, float)), flush=True)


def kernel_table(rows, errs, launches_by_path):
    """The {"kernels": [...]} entries, one per row: each kernel's launches
    on its own slice's main path (MAIN_PATH) and on every path driven, its
    times (as called and alone), bound and library time."""
    table = []
    for r in rows:
        bound_ms, bound_by = bound(r.nbytes, r.ops)
        table.append({
            "name": r.name, "route": "cuda", "source": KERNELS[r.name][3],
            "replaces": KERNELS[r.name][4],
            "launches": launches_by_path[MAIN_PATH[r.name]][r.name],
            "launches_by_path": {path: counts[r.name] for path, counts
                                 in launches_by_path.items()},
            "max_abs_err": errs[r.name], "ms": r.ms, "alone_ms": r.alone_ms,
            "plain_ms": r.plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r.lib_ms, "library": r.lib, **(r.extra or {}),
        })
    check(sorted(r["name"] for r in table) == sorted(KERNELS),
          "the kernels line misses a kernel")
    return table


def main() -> int:
    with Phase("device", 90):
        card = phase_device()
    import torch

    from tpugs_torch import cuda_lib

    dev = torch.device("cuda", 0)
    with Phase("build", 240):
        phase_build()
    errs = {}
    with Phase("kernels", 300):
        phase_kernels(dev, errs)
    with Phase("grad-kernels", 300):
        phase_grad_kernels(dev, errs)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("cli", 600):
            params, cli_launches, _ = phase_cli(tmp, dev)
        with Phase("timing", 480):
            print_rows(phase_timing(dev, params, errs), "render frame")
        with Phase("train-step", 600):
            rows, step_launches, _ = phase_train_step(dev, errs)
            print_rows(rows, "train frame")
        with Phase("bench", 300):
            bench_rows, bench_launches = phase_bench(dev, errs)
            print_rows(bench_rows, "bench 50k frame")
        with Phase("graph", 300):
            graph_launches = phase_graph(dev)
        with Phase("garden-grad-paths", 300):
            classic_launches, scatter_launches = phase_garden_grad_paths(
                dev, errs)
        with Phase("carry", 300):
            carry_rows, carry_launches = phase_carry(dev, params, errs)
            print_rows(carry_rows, "train frame")
        with Phase("viewer", 300):
            anchor_launches, drag_launches = phase_viewer(dev, params)
        with Phase("oracles", 300):
            pre_launches, fast_launches, scan_launches = phase_oracles(
                dev, params, errs, card)
        del params
        with Phase("large-scene", 600):
            large_rows, large_launches, _, _, k1_large = phase_large_scene(
                dev, errs)
            print_rows(large_rows, "2^24 train frame")
        rows = [r._replace(extra={**r.extra, **k1_large})
                if r.name == "expand" else r for r in rows]
        with Phase("train-cli", 900):
            train_cli_launches = phase_train_cli(tmp, dev)
        with Phase("train-densify", 900):
            adc_launches, eval_launches, mcmc_launches = phase_train_densify(
                tmp, dev, card)
        with Phase("tools", 300):
            phase_tools(tmp, dev)
        with Phase("mesh", 600):
            (mesh_launches, rank0_launches, rank1_launches,
             mesh_block_launches) = phase_mesh(tmp, dev, errs)
    torch.cuda.synchronize()
    cuda_lib.check_guards()  # no kernel found its inputs out of contract
    table = kernel_table(rows + large_rows + carry_rows, errs, {
        "train_step": step_launches, "large_train_step": large_launches,
        "carry_train_frame": carry_launches,
        "classic_garden_frame": classic_launches,
        "scatter_garden_frame": scatter_launches,
        "train_cli": train_cli_launches, "render_cli": cli_launches,
        "adc_train_cli": adc_launches, "adc_eval": eval_launches,
        "mcmc_train_cli": mcmc_launches, "viewer_anchor": anchor_launches,
        "viewer_drag": drag_launches, "mesh_1x1_steps": mesh_launches,
        "mesh_1x2_rank0_steps": rank0_launches,
        "mesh_1x2_rank1_steps": rank1_launches,
        "pre_aligned_garden_frame": pre_launches,
        "fast_presort_render_frame": fast_launches,
        "scan_frame": scan_launches, **bench_launches, **graph_launches,
        **mesh_block_launches})
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mesh_cli(argv) -> int:
    """Phase mesh (e)'s rank under torchrun: the train CLI with argv, then
    the graph runners' captures and replays on a line of their own."""
    from tpugs_torch.apps.train import main as train_main
    from tpugs_torch.train.graph import BlockRunner

    rc = train_main(argv)
    print(f"graph: captures {BlockRunner.captures_total} replays "
          f"{BlockRunner.replays_total}", flush=True)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-cli"]:
        sys.exit(mesh_cli(sys.argv[2:]))
    sys.exit(main())

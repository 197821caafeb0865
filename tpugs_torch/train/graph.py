"""Blocks of train steps as replays of a captured CUDA graph: the port's
counterpart of the JAX package's one compiled program per block of K steps
(make_train_multi_step's lax.scan, bench.py's jitted k steps).

A step function (`body`) is captured once as a CUDA graph and replayed once
a step. It keeps its state in static device buffers, which it reads and
updates in place. Its per-step inputs are numbers (a view index, the
schedule step, a background colour): the caller stages a block's rows of
them with one copy from pinned host memory, and the step reads row
`counter` of the device copy (`row()`) and then adds one to the counter
(`advance()`), so each replay takes the next row. The step's loss lands in
`losses[counter]` (`put_loss`). Nothing in a block reads back to the host
or copies from it; its caller reads the losses once after the block.

The first steps for a new key (the SH degree) run eagerly, on the capture's
side stream, as real steps of the run: they fill the lazy caches (the SSIM
blur matrices, the device constants, the kernel library, the autograd
engine's threads, a communicator's set-up) before the capture. They count
across blocks, so blocks shorter than the warm-up capture too, from the
block that completes it. Then the step is captured once and replayed for
the rest. A capture that fails raises: there is no eager
fallback on the card. The graphs of one runner share one memory pool;
those whose key the caller says can no longer occur are released.

The kernel wrappers count a launch once when the capture records it; a
replay runs every captured kernel again without passing through them, so
a run's kernel launches are the wrappers' counts less the captures plus
the replays (each captured step holds each of its kernels once). Each
runner counts its own (`captures`, `replays`), and the class counts those
of every runner (`captures_total`, `replays_total`) for a run whose
runners are out of reach, as the train CLI's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

WARMUP_STEPS = 2  # eager steps before a capture


def same_layout(tensors, buffers) -> bool:
    """True when every tensor has its buffer's shape and type."""
    return [(t.shape, t.dtype) for t in tensors] == [
        (b.shape, b.dtype) for b in buffers]


def load_buffers(buffers, tensors) -> None:
    """Each tensor's values into its static buffer: a device copy, skipped
    for a tensor that is its buffer (the state a block returned)."""
    for b, t in zip(buffers, tensors):
        if b.data_ptr() != t.data_ptr():
            b.copy_(t)


class BlockRunner:
    """Runs blocks of one step function on the card as replays of its
    captured CUDA graphs, one graph per key. `width`: the numbers staged per
    step; `generators`: the CUDA generators the step draws from, registered
    with every graph (a replay draws from the generator's state as it is
    when the replay is launched)."""

    captures_total = 0
    replays_total = 0

    def __init__(self, device: torch.device, width: int, generators=()):
        self.device = device
        self.width = width
        self.generators = tuple(generators)
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        # key -> its graph, or the eager warm-up steps it has had so far
        self.graphs: dict = {}
        self.rows = None  # [capacity, width] f32: the staged inputs
        self.losses = None  # [capacity] f32: each step's loss
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.captures = 0
        self.replays = 0
        self.capture_seconds: list[float] = []

    def release(self, keep=lambda key: False) -> None:
        """Drop the graphs whose key `keep` rejects (all by default)."""
        for key in [k for k in self.graphs if not keep(k)]:
            del self.graphs[key]

    def stage(self, rows: np.ndarray) -> None:
        """The block's inputs [K, width] to the device in one copy from
        pinned memory (the caching host allocator keeps that memory until
        the copy has run), and the counter to row 0."""
        k = rows.shape[0]
        if self.rows is None or self.rows.shape[0] < k:
            cap = max(k, 32)
            self.rows = torch.zeros((cap, self.width), dtype=torch.float32,
                                    device=self.device)
            self.losses = torch.zeros((cap,), dtype=torch.float32,
                                      device=self.device)
            self.release()  # they read the old buffers
        host = torch.from_numpy(
            np.ascontiguousarray(rows, dtype=np.float32)).pin_memory()
        self.rows[:k].copy_(host, non_blocking=True)
        self.counter.zero_()

    def row(self) -> torch.Tensor:
        """This step's staged row [width], read on the device through the
        counter."""
        return self.rows.index_select(0, self.counter)[0]

    def put_loss(self, loss: torch.Tensor) -> None:
        self.losses.index_copy_(0, self.counter, loss.reshape(1))

    def advance(self) -> None:
        self.counter.add_(1)

    def run(self, key, k: int, body, before_step=None) -> int:
        """k steps of body(): replays of the graph for `key`, captured
        first, once the key has had WARMUP_STEPS eager steps, if there is
        none. before_step(j), if given, runs on the host before step j (it
        may re-seed the generators). Returns the number of eager steps."""
        j = 0
        graph = self.graphs.get(key, 0)
        if not isinstance(graph, torch.cuda.CUDAGraph):
            main = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                while j < k and graph + j < WARMUP_STEPS:
                    if before_step is not None:
                        before_step(j)
                    body()
                    j += 1
            main.wait_stream(self.stream)
            self.graphs[key] = graph + j
            if j == k:
                return j
            graph = self._capture(body)
            self.graphs[key] = graph
        for i in range(j, k):
            if before_step is not None:
                before_step(i)
            graph.replay()
        self.replays += k - j
        BlockRunner.replays_total += k - j
        return j

    def _capture(self, body) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            body()
        self.capture_seconds.append(time.perf_counter() - t0)
        self.captures += 1
        BlockRunner.captures_total += 1
        return graph

"""Gloo worlds for the mesh tests of tpugs_torch: spawned CPU ranks, as
tpugs' tests use 8 virtual CPU devices.

run_world(n, "module:function", tmp, **kw) starts n processes with the
`spawn` method (never fork: the test process's JAX threads are running),
joins them into one gloo world through a FileStore in `tmp` (no TCP port:
pytest-xdist runs several workers at once), calls function(mesh-free
rank, world, **kw) on each rank and returns the ranks' results, pickled
through files. A rank that raises fails the test with its traceback; a
world that outlives its timeout is killed and fails the test, so a hung
collective cannot stall the suite. The ranks import tpugs_torch and never
JAX."""
from __future__ import annotations

import datetime
import importlib
import os
import pathlib
import pickle
import sys
import time
import traceback

WORLD_TIMEOUT_S = 240.0  # the whole world, start-up included
COLLECTIVE_TIMEOUT_S = 120.0  # one collective


def _entry(rank: int, world: int, store: str, target: str, out_dir: str,
           kwargs: dict):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(rank, world,
                                                           **kwargs)
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(n: int, target: str, tmp, timeout: float = WORLD_TIMEOUT_S,
              **kwargs) -> list:
    import torch.multiprocessing as mp

    out = pathlib.Path(tmp) / f"world_{target.split(':')[1]}_{time.time_ns()}"
    out.mkdir(parents=True)
    store = out / "store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, n, str(store), target,
                                              str(out), kwargs))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [(out / f"rank{r}.err").read_text() for r in range(n)
            if (out / f"rank{r}.err").exists()]
    if errs:
        raise AssertionError(f"{target}: a rank failed:\n" + errs[0])
    if hung:
        raise AssertionError(f"{target}: ranks {hung} still running after "
                             f"{timeout:.0f} s; killed")
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"{target}: exit codes {codes}")
    results = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results

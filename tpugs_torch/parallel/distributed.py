"""Process-group set-up for multi-rank training, as
tpugs/parallel/distributed.py.

tpugs starts one process per host, each seeing its host's devices. The
port starts one process per card, so a rank is a card:

  torchrun --nproc-per-node G -m tpugs_torch.apps.train -d scene -o out \
      --mesh data=D,gauss=G                      # one host, D*G = G cards

or, across hosts, one command per rank with tpugs' variables:

  TPUGS_DISTRIBUTED=1 TPUGS_COORDINATOR=host0:8476 \
  TPUGS_NUM_PROCESSES=<ranks> TPUGS_PROCESS_ID=<rank> LOCAL_RANK=<card> \
  python -m tpugs_torch.apps.train -d scene -o out --mesh data=8,gauss=4

torchrun's RANK, WORLD_SIZE and LOCAL_RANK are read when TPUGS_DISTRIBUTED
is not set. The backend is NCCL on the card and gloo on the CPU unless one
is named.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective that waits longer fails the run


def maybe_init_distributed(device="cuda", backend: str | None = None,
                           log=print, timeout_s: float = TIMEOUT_S) -> bool:
    """Initialise torch.distributed from the environment when a launcher
    set it (TPUGS_DISTRIBUTED=1, or torchrun's RANK and WORLD_SIZE), with
    the rank's card as the current device. Returns True when it did."""
    env = os.environ
    if env.get("TPUGS_DISTRIBUTED", "") in ("1", "true"):
        coord = env.get("TPUGS_COORDINATOR")
        if not coord:
            raise ValueError("TPUGS_DISTRIBUTED=1 needs TPUGS_COORDINATOR "
                             "(host:port), TPUGS_NUM_PROCESSES and "
                             "TPUGS_PROCESS_ID")
        init = f"tcp://{coord}"
        world = int(env["TPUGS_NUM_PROCESSES"])
        rank = int(env["TPUGS_PROCESS_ID"])
    elif "RANK" in env and "WORLD_SIZE" in env:
        init = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if dist.is_initialized():
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log(f"distributed: rank {rank}/{world}, backend {backend}"
        + (f", cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
           else ""))
    return True


def shutdown_distributed():
    """Destroy the process group maybe_init_distributed made."""
    if dist.is_initialized():
        dist.destroy_process_group()

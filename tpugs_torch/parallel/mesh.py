"""The ("data", "gauss") mesh, as tpugs/parallel/mesh.py, over
torch.distributed ranks.

tpugs runs one process that sees every device of the mesh, and XLA writes
the collectives. The port runs one process per card (`torchrun
--nproc-per-node G`, or one launch per rank with the TPUGS_* variables of
parallel/distributed.py): rank r sits at data_index = r // G and
gauss_index = r % G, the row-major layout of np.asarray(devs).reshape(D, G).

A Mesh holds the process groups of its axes: the gauss group (the G ranks
of its data row: the tile exchange, the colour gather, sums over shards),
the data group (the D ranks of its gauss column: the mean over views) and
the group of all its ranks (statistics over both axes). Every collective
names one of them (parallel/comm.py); none uses the default group, so one
world can hold several meshes. An axis of size 1 has no group and its
collectives are the identity, so a 1x1 mesh needs no process group.

Backends: NCCL on the card, gloo on the CPU. A mesh on the card whose
world runs another backend raises unless the caller names that backend.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import torch
import torch.distributed as dist

BOTH = ("data", "gauss")  # the axis name of collectives over both axes


def _launch_hint(d: int, g: int) -> str:
    return (f"launch one process per rank: torchrun --nproc-per-node {d * g} "
            f"(or set TPUGS_DISTRIBUTED=1 with TPUGS_COORDINATOR, "
            f"TPUGS_NUM_PROCESSES and TPUGS_PROCESS_ID on each host)")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    data: int
    gauss: int
    rank: int  # this rank's index within the mesh, row-major
    device: torch.device
    backend: str | None  # the world's backend, None without a process group
    groups: dict  # "data" / "gauss" / BOTH -> ProcessGroup, or None (size 1)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "gauss": self.gauss}

    @property
    def size(self) -> int:
        return self.data * self.gauss

    @property
    def data_index(self) -> int:
        return self.rank // self.gauss

    @property
    def gauss_index(self) -> int:
        return self.rank % self.gauss

    @property
    def primary(self) -> bool:
        """Rank 0 of the mesh: the one that writes files and logs."""
        return self.rank == 0

    def axis_size(self, axis) -> int:
        """Ranks along "data", "gauss" or BOTH."""
        return self.size if axis == BOTH else self.shape[axis]

    def axis_index(self, axis) -> int:
        """This rank's index along "data", "gauss" or BOTH."""
        if axis == BOTH:
            return self.rank
        return self.data_index if axis == "data" else self.gauss_index

    def group(self, axis):
        """The process group of "data", "gauss" or BOTH (None: size 1)."""
        return self.groups[axis]


def default_device(device=None) -> torch.device:
    """The rank's device: 'cpu', an explicit 'cuda:i', or for 'cuda' the
    card LOCAL_RANK names (torchrun's variable; 0 without it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; a mesh on the CPU needs device='cpu' "
                "(--device cpu) and the gloo backend")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_mesh(axis_sizes: Sequence[int] | None = None, device=None,
              backend: str | None = None) -> Mesh:
    """A (data, gauss) mesh over the ranks of the initialised world, or a
    1x1 mesh without one. Default: every rank on "data". Every rank of the
    world calls this together (it creates the groups). `backend` names the
    world's backend when it is not the device's own (NCCL on the card,
    gloo on the CPU)."""
    dev = default_device(device)
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if axis_sizes is None:
        axis_sizes = (world, 1)
    d, g = (int(a) for a in axis_sizes)
    if d < 1 or g < 1:
        raise ValueError(f"mesh data={d},gauss={g}: sizes must be >= 1")
    if d * g != world:
        if not initialised:
            raise ValueError(
                f"mesh data={d},gauss={g} needs {d * g} ranks and no process "
                f"group is initialised; {_launch_hint(d, g)}")
        raise ValueError(
            f"mesh data={d},gauss={g} needs {d * g} ranks, the world has "
            f"{world}; {_launch_hint(d, g)}")
    world_backend = dist.get_backend() if initialised else None
    if world_backend is not None:
        expected = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if world_backend != expected:
            raise ValueError(
                f"the world runs {world_backend!r} but a mesh on {dev.type} "
                f"uses {expected!r}; name backend={world_backend!r} to use it")
    rank = dist.get_rank() if initialised else 0
    groups = {"data": None, "gauss": None, BOTH: None}
    if world > 1:
        # Every rank creates every group, in the same order.
        for i in range(d):
            grp = dist.new_group([i * g + j for j in range(g)]) if g > 1 else None
            if i == rank // g:
                groups["gauss"] = grp
        for j in range(g):
            grp = dist.new_group([i * g + j for i in range(d)]) if d > 1 else None
            if j == rank % g:
                groups["data"] = grp
        groups[BOTH] = dist.new_group(list(range(world)))
    return Mesh(data=d, gauss=g, rank=rank, device=dev,
                backend=world_backend, groups=groups)

"""Pair -> gaussian gradient reductions, as in tpugs/ops/pallas/segreduce.py:
the sorted segment sum (segment_reduce_sorted_pallas, the default
backward's) and the interval segment sum (segment_reduce_pallas, the
classic backward's, below).

The backward compositor writes one gradient column per aligned pair slot.
Each slot's key is its gaussian id, or SENTINEL where the slot holds no
pair; the columns are masked to zero there before they arrive (an unwritten
kernel slot may hold NaN). One unstable sort by key groups every gaussian's
slots, a searchsorted of the n + 1 ids 0..n over the sorted keys gives each
gaussian's run, and the segment sum adds each run in sorted order. Sentinel
slots sort past every run and add nothing. The order inside a run follows
the sort, so the sums may differ from a scatter-add at ulp scale; they are
deterministic for a given sort.

The sort and the searchsorted are PyTorch, as the JAX package leaves its
sort to XLA. The CUDA kernel is csrc/segreduce.cu (it replaces
tpugs/ops/pallas/segreduce.py::_segreduce_sorted_kernel). A CUDA tensor goes
to the kernel, a CPU tensor to `segment_sum_sorted_plain`.

The interval segment sum takes per-slot gradient rows [P, NUM_ATTR] already
in the gaussian-major expansion order, where gaussian g's slots are one
interval [red_start[g], red_start[g] + red_count[g]) (binning's
reduce_meta), monotone and disjoint, and adds each interval in slot order.
It needs no key, so it has no limit on n. Its kernel is also in
csrc/segreduce.cu (it replaces tpugs/ops/pallas/segreduce.py::
_segreduce_kernel); a CPU tensor goes to `segment_reduce_plain`. The
kernel checks the intervals against exp_end itself (cuda_lib's guard
words), so the wrapper reads nothing back from the device.
"""
from __future__ import annotations

import torch

from tpugs_torch import cuda_lib
from tpugs_torch.ops.pack import NUM_ATTR

SENTINEL = 1 << 25  # key of a slot with no pair: past any gaussian id
MAX_N = 1 << 24  # the reference's f32-exact id limit, kept as the contract


def segment_sum_sorted_plain(cols: torch.Tensor, bounds: torch.Tensor,
                             n: int) -> torch.Tensor:
    """Plain version: column g of the output adds cols[:, bounds[g]] ..
    cols[:, bounds[g + 1] - 1] one by one from zero, as the kernel does; all
    gaussians whose run is at least j + 1 long take their j-th slot in one
    step."""
    b = bounds.to(torch.int64)
    lo, length = b[:-1], b[1:] - b[:-1]
    out = torch.zeros((cols.shape[0], n), dtype=torch.float32,
                      device=cols.device)
    longest = int(length.max()) if n else 0
    for j in range(longest):
        act = torch.nonzero(length > j).squeeze(1)
        out[:, act] = out[:, act] + cols[:, lo[act] + j]
    return out


def segment_sum_sorted(cols: torch.Tensor, bounds: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Per-gaussian sums over sorted runs. cols [NUM_ATTR, P] f32 in key
    order, bounds [n + 1] int32 (gaussian g's run is [bounds[g],
    bounds[g + 1])). Returns [NUM_ATTR, n] f32."""
    if cols.device.type == "cpu":
        return segment_sum_sorted_plain(cols, bounds, n)
    dev = cols.device
    cuda_lib.require(cols, "cols", torch.float32, dev, 2)
    cuda_lib.require(bounds, "bounds", torch.int32, dev, 1)
    if cols.shape[0] != NUM_ATTR or bounds.shape[0] != n + 1:
        raise ValueError(f"segment_sum_sorted: cols {tuple(cols.shape)}, "
                         f"{bounds.shape[0]} bounds; expected [{NUM_ATTR}, P] "
                         f"and {n + 1}")
    if not 0 <= n < MAX_N:
        raise ValueError(f"segment_sum_sorted: n = {n} outside [0, {MAX_N})")
    lib = cuda_lib.lib()
    out = torch.empty((NUM_ATTR, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    code = lib.tpugs_segreduce_sorted(dev.index, cols.data_ptr(),
                                      cols.shape[1], bounds.data_ptr(), n,
                                      out.data_ptr(), cuda_lib.stream_ptr(dev))
    segment_sum_sorted.launches += 1
    cuda_lib.check("tpugs_segreduce_sorted", code)
    return out


segment_sum_sorted.launches = 0


def sort_by_key(key: torch.Tensor, cols: torch.Tensor, n: int):
    """The unstable key sort and the run bounds -> (sorted cols [NUM_ATTR,
    P], bounds [n + 1] int32)."""
    skey, perm = torch.sort(key, stable=False)
    ids = torch.arange(n + 1, dtype=skey.dtype, device=skey.device)
    bounds = torch.searchsorted(skey, ids).to(torch.int32)
    return cols[:, perm].contiguous(), bounds


def segment_reduce_sorted(key: torch.Tensor, cols: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Sum gradient columns per gaussian. key [P] int32: gaussian id per
    slot, SENTINEL for slots with no pair; cols [NUM_ATTR, P] f32, already
    zero on those slots. Returns [NUM_ATTR, n] f32."""
    if n >= MAX_N:
        raise ValueError(f"segment_reduce_sorted: n = {n} >= {MAX_N}")
    scols, bounds = sort_by_key(key, cols, n)
    return segment_sum_sorted(scols, bounds, n)


def segment_reduce_plain(rows: torch.Tensor, red_start: torch.Tensor,
                         red_count: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: column g of the output adds rows[red_start[g]] ..
    rows[red_start[g] + red_count[g] - 1] one by one from zero, as the
    kernel does; all gaussians whose interval is at least j + 1 long take
    their j-th slot in one step."""
    lo, length = red_start.to(torch.int64), red_count.to(torch.int64)
    out = torch.zeros((NUM_ATTR, n), dtype=torch.float32, device=rows.device)
    longest = int(length.max()) if n else 0
    for j in range(longest):
        act = torch.nonzero(length > j).squeeze(1)
        out[:, act] = out[:, act] + rows[lo[act] + j].T
    return out


def segment_reduce(rows: torch.Tensor, red_start: torch.Tensor,
                   red_count: torch.Tensor, exp_end: int,
                   n: int) -> torch.Tensor:
    """Per-gaussian sums over monotone, disjoint slot intervals. rows [P,
    NUM_ATTR] f32 in expansion order, red_start/red_count [n] int32, every
    interval inside [0, exp_end) and exp_end <= P. Returns [NUM_ATTR, n]
    f32, zero for an empty interval. On the card an interval outside [0,
    exp_end) is not read: its sums are NaN, and cuda_lib raises ValueError
    at the first launch or check_guards() after the kernel has run."""
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, red_start, red_count, n)
    dev = rows.device
    cuda_lib.require(rows, "rows", torch.float32, dev, 2)
    cuda_lib.require(red_start, "red_start", torch.int32, dev, 1)
    cuda_lib.require(red_count, "red_count", torch.int32, dev, 1)
    if rows.shape[1] != NUM_ATTR or red_start.shape[0] != n \
            or red_count.shape[0] != n:
        raise ValueError(f"segment_reduce: rows {tuple(rows.shape)}, "
                         f"{red_start.shape[0]} starts, {red_count.shape[0]} "
                         f"counts; expected [P, {NUM_ATTR}] and {n}")
    if not 0 <= n < 2**31 or not 0 <= exp_end <= rows.shape[0]:
        raise ValueError(f"segment_reduce: n = {n}, exp_end = {exp_end} of "
                         f"{rows.shape[0]} rows")
    lib = cuda_lib.lib()
    out = torch.empty((NUM_ATTR, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    code = lib.tpugs_segreduce_interval(
        dev.index, rows.data_ptr(), red_start.data_ptr(), red_count.data_ptr(),
        n, exp_end, out.data_ptr(),
        cuda_lib.guard_word("tpugs_segreduce_interval"),
        cuda_lib.stream_ptr(dev))
    segment_reduce.launches += 1
    cuda_lib.check("tpugs_segreduce_interval", code)
    return out


segment_reduce.launches = 0

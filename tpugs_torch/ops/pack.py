"""Compositor attribute layout and the align-copy kernel's wrapper, as in
tpugs/ops/pallas/pack.py.

The forward compositor streams each tile's attribute segment from a
[ATTR_ROWS, P_aligned] table whose segments start on 128-column
boundaries. Tile t's entries occupy [tile_start[t], tile_start[t] + count)
of the compact sorted table and [astart[t], astart[t] + count) of the
aligned one; the align-copy moves each segment and zeroes the gap up to
the next 128 boundary, so row VALID_ROW is 0 there.

Rows: x y ca cb cc opac r g b gid valid (pad to 16), with the conic
pre-scaled to (ca, cb, cc) = (-a/2, -b, -c/2).

The CUDA kernel is csrc/align_copy.cu (it replaces
tpugs/ops/pallas/pack.py::_align_copy_kernel). A CUDA tensor goes to the
kernel, a CPU tensor to `align_copy_plain`. The kernel checks the segments'
bounds itself (cuda_lib's guard words), so the wrapper reads nothing back
from the device.
"""
from __future__ import annotations

import torch

from tpugs_torch import cuda_lib
from tpugs_torch.device import device_constant

ATTR_ROWS = 16  # x y ca cb cc opac r g b gid valid (pad)
NUM_ATTR = 9  # compositor attributes x .. b, and gradients per pair
GID_ROW = 9
CHUNK = 512  # the reference's DMA chunk, kept for p_aligned_chunked
LANE_ALIGN = 128  # aligned segment start granularity
VALID_ROW = 10
CONIC_SCALE = (-0.5, -1.0, -0.5)  # the conic's pre-scale in rows 2-4


def _pad(counts: torch.Tensor) -> torch.Tensor:
    return (counts + (LANE_ALIGN - 1)) // LANE_ALIGN * LANE_ALIGN


def aligned_offsets(tile_start: torch.Tensor, tile_stop: torch.Tensor):
    """128-granular aligned segment starts from (possibly clamped) compact
    segment bounds -> (astart [T], astop [T], counts [T]) int32."""
    counts = (tile_stop - tile_start).to(torch.int32)
    padded = _pad(counts)
    astart = (torch.cumsum(padded, 0, dtype=torch.int64) - padded).to(torch.int32)
    return astart, astart + counts, counts


def aligned_length(astart: torch.Tensor, counts: torch.Tensor) -> int:
    """Columns of the aligned table: the last tile's padded end (one host
    read, so for tools and tests: the render path sizes the table by
    p_aligned_chunked's static bound)."""
    if astart.shape[0] == 0:
        return 0
    return int(astart[-1].to(torch.int64) + _pad(counts[-1]))


def p_aligned_chunked(pair_capacity: int, num_tiles: int) -> int:
    """The reference's aligned capacity: every tile adds at most
    LANE_ALIGN - 1 padding, plus CHUNK of tail slack for its chunked DMA.
    An upper bound on aligned_length for any binning of that capacity."""
    raw = pair_capacity + num_tiles * (LANE_ALIGN - 1)
    return -(-raw // CHUNK) * CHUNK + CHUNK


def gaussian_attrs(means2d, conic, rgb, opac) -> torch.Tensor:
    """The nine compositor attributes per gaussian -> [N, NUM_ATTR]: x y,
    the pre-scaled conic (-a/2, -b, -c/2), opac, r g b."""
    scale = device_constant(CONIC_SCALE, conic.device, conic.dtype)
    return torch.cat([means2d, conic * scale, opac[:, None], rgb], dim=1)


def pack_compact_attrs(pair_gauss, means2d, conic, rgb, opac, p_pad: int):
    """Per-pair attributes in compact sorted order -> [ATTR_ROWS, p_pad]
    (columns past the pairs are zero)."""
    attr = gaussian_attrs(means2d, conic, rgb, opac)
    gathered = attr[pair_gauss.to(torch.int64)]  # [P, 9]
    gid = pair_gauss.to(torch.float32)[:, None]
    rows = torch.cat([gathered, gid, torch.ones_like(gid)], dim=1)
    out = torch.zeros((ATTR_ROWS, p_pad), dtype=torch.float32, device=rows.device)
    out[: rows.shape[1], : rows.shape[0]] = rows.T
    return out


def align_copy_plain(attr_c: torch.Tensor, tile_start: torch.Tensor,
                     astart: torch.Tensor, counts: torch.Tensor,
                     p_aligned: int) -> torch.Tensor:
    """Plain version of the align-copy: one vectorised gather over the
    aligned columns, each finding its tile by a search over astart. Gap and
    tail columns are zero."""
    dev = attr_c.device
    j = torch.arange(p_aligned, dtype=torch.int64, device=dev)
    a64 = astart.to(torch.int64)
    # A zero-count tile shares its start with the next tile, so the last
    # tile whose start is <= j is the one whose span holds j.
    owner = torch.clamp(torch.searchsorted(a64, j, right=True) - 1, min=0)
    k = j - a64[owner]
    take = k < counts.to(torch.int64)[owner]
    src = tile_start.to(torch.int64)[owner] + k
    out = torch.zeros((attr_c.shape[0], p_aligned), dtype=attr_c.dtype, device=dev)
    out[:, take] = attr_c[:, src[take]]
    return out


def align_copy(attr_c: torch.Tensor, tile_start: torch.Tensor,
               astart: torch.Tensor, counts: torch.Tensor,
               p_aligned: int) -> torch.Tensor:
    """Re-lay compact per-tile segments of attr_c [ATTR_ROWS, Pc] f32 into
    [ATTR_ROWS, p_aligned]: tile t's segment at astart[t], zeros up to its
    128 boundary and past the last tile's padded end. The segments' contract
    (each starts on a 128 boundary, its padded span ends at or before the
    next tile's start and p_aligned, its entries lie in attr_c) is checked
    by the kernel on the card: there cuda_lib raises ValueError at the
    first later launch or check_guards() once it has run, and the kernel
    reads and writes nothing outside attr_c and the output."""
    if attr_c.device.type == "cpu":
        return align_copy_plain(attr_c, tile_start, astart, counts, p_aligned)
    dev = attr_c.device
    cuda_lib.require(attr_c, "attr_c", torch.float32, dev, 2)
    for name, t in (("tile_start", tile_start), ("astart", astart),
                    ("counts", counts)):
        cuda_lib.require(t, name, torch.int32, dev, 1)
    num_tiles = tile_start.shape[0]
    if attr_c.shape[0] != ATTR_ROWS or astart.shape[0] != num_tiles \
            or counts.shape[0] != num_tiles:
        raise ValueError(f"align_copy: attr_c {tuple(attr_c.shape)}, "
                         f"{num_tiles} tiles; expected [{ATTR_ROWS}, Pc]")
    lib = cuda_lib.lib()
    out = torch.empty((ATTR_ROWS, p_aligned), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return out
    code = lib.tpugs_align_copy(
        dev.index, attr_c.data_ptr(), attr_c.shape[1], tile_start.data_ptr(),
        astart.data_ptr(), counts.data_ptr(), num_tiles, out.data_ptr(),
        p_aligned, cuda_lib.guard_word("tpugs_align_copy"),
        cuda_lib.stream_ptr(dev))
    align_copy.launches += 1
    cuda_lib.check("tpugs_align_copy", code)
    return out


align_copy.launches = 0

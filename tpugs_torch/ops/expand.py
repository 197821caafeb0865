"""Pair expansion: the kernel wrapper and its plain PyTorch version.

Each gaussian's touched tile rect becomes one slot per (gaussian, tile), in
gaussian-major order, with the pixel-exact corner cull of
binning.bin_gaussians. Slot s of gaussian g lies in [offset[g],
offset[g] + count[g]); slots at or past `p_out` are dropped, so with
p_out = pair_capacity the pairs past the capacity go exactly as the
reference's clamped chunk offsets drop them. p_out is static, as the
reference's expand capacity: the slots past the last gaussian's end, which
no gaussian owns, hold the sentinel too (the wrapper fills the outputs
before the launch). A culled or unowned slot holds the sentinel: tile =
num_tiles, depth = +inf; an unowned one also gid 0 and zero attributes.
Validity is `tile < num_tiles`.

Carry mode (`atab`, the reference's carry_attrs): a second table of the
nine compositor attributes per gaussian (x y ca cb cc op r g b, conic
pre-scaled), and every slot also writes its gaussian's nine values into
[9, p_out].

The CUDA kernel is csrc/expand.cu (it replaces
tpugs/ops/pallas/expand.py::_expand_kernel in its 4-row mode and in its
carry_attrs mode). A CUDA tensor goes to the kernel, a CPU tensor to
`expand_pairs_plain`. expand_pairs counts its launches per mode:
`.launches` (4-row) and `.launches_carry`.
"""
from __future__ import annotations

import torch

from tpugs_torch import cuda_lib

# The reference kernel's chunking, kept for expand_capacity.
GC = 256  # gaussians per chunk
OB = 512  # output slots per block
PAD_ALIGN = 128  # per-chunk output padding

ITAB_ROWS = 5  # offset, count, tx0, ty0, w (>= 1)
FTAB_ROWS = 4  # gx, gy, r2 (cull radius squared), depth key
ATAB_ROWS = 9  # carry mode: x y ca cb cc op r g b


def expand_capacity(pair_capacity: int, n: int) -> int:
    """The reference kernel's padded output length for n gaussians: pair
    capacity + worst-case per-chunk padding + one block of tail slack. The
    port's expansion needs no padding; its output is pair_capacity
    slots."""
    n_chunks = -(-n // GC)
    raw = pair_capacity + n_chunks * (PAD_ALIGN - 1) + OB
    return -(-raw // OB) * OB


def expand_pairs_plain(itab: torch.Tensor, ftab: torch.Tensor, p_out: int,
                       num_tiles: int, ntx: int, tile_w: int, tile_h: int,
                       atab: torch.Tensor | None = None):
    """Plain version of the expansion: one vectorised pass over the slots,
    each finding its owner by a search over the offsets. Returns (tile i32
    [p_out], depth f32 [p_out], gid i32 [p_out]) and, with atab, the
    attributes f32 [9, p_out]."""
    dev = itab.device
    if itab.shape[1] == 0:
        return _sentinel(p_out, num_tiles, dev, atab is not None)
    off, cnt, tx0, ty0, w = (r.to(torch.int64) for r in itab)
    gx, gy, r2, depth = ftab
    slots = torch.arange(p_out, dtype=torch.int64, device=dev)
    owned = slots < off[-1] + cnt[-1]  # past it no gaussian owns a slot
    # The owner is the last gaussian whose offset is <= slot; a zero-count
    # gaussian shares its offset with the next one, so it never owns a slot.
    g = torch.searchsorted(off, slots, right=True) - 1
    local = slots - off[g]
    wg = w[g]
    tx = tx0[g] + local % wg
    ty = ty0[g] + local // wg
    px0 = (tx * tile_w).to(torch.float32)
    py0 = (ty * tile_h).to(torch.float32)
    gxg, gyg = gx[g], gy[g]
    dx = torch.clamp(gxg, min=px0, max=px0 + (tile_w - 1)) - gxg
    dy = torch.clamp(gyg, min=py0, max=py0 + (tile_h - 1)) - gyg
    hit = (dx * dx + dy * dy <= r2[g]) & owned
    tile = torch.where(hit, ty * ntx + tx, torch.full_like(tx, num_tiles))
    dep = torch.where(hit, depth[g], torch.full_like(gxg, float("inf")))
    gid = torch.where(owned, g, torch.zeros_like(g))
    out = (tile.to(torch.int32), dep, gid.to(torch.int32))
    if atab is None:
        return out
    return out + (torch.where(owned, atab[:, g], atab.new_zeros(())),)


def _sentinel(p_out: int, num_tiles: int, dev, carry: bool):
    """p_out unowned slots: (tile num_tiles, depth +inf, gid 0) and, in
    carry mode, zero attributes."""
    out = (torch.full((p_out,), num_tiles, dtype=torch.int32, device=dev),
           torch.full((p_out,), float("inf"), dtype=torch.float32,
                      device=dev),
           torch.zeros((p_out,), dtype=torch.int32, device=dev))
    if carry:
        out += (torch.zeros((ATAB_ROWS, p_out), dtype=torch.float32,
                            device=dev),)
    return out


def expand_pairs(itab: torch.Tensor, ftab: torch.Tensor, p_out: int,
                 num_tiles: int, ntx: int, tile_w: int, tile_h: int,
                 atab: torch.Tensor | None = None):
    """Expand gaussians into p_out (tile, depth, gid) slots. itab int32
    [5, N] (offset, count, tx0, ty0, w >= 1), ftab f32 [4, N] (gx, gy, r2,
    depth key); offsets are the exclusive prefix sum of the counts (clipped
    at p_out or not). Returns (tile i32 [p_out], depth f32 [p_out], gid i32
    [p_out]); with atab f32 [9, N] (carry mode) also each slot's attributes
    f32 [9, p_out]. The outputs start as the sentinel (a fill on the
    device), which the kernel overwrites in every owned slot."""
    if itab.device.type == "cpu":
        return expand_pairs_plain(itab, ftab, p_out, num_tiles, ntx, tile_w,
                                  tile_h, atab)
    dev = itab.device
    cuda_lib.require(itab, "itab", torch.int32, dev, 2)
    cuda_lib.require(ftab, "ftab", torch.float32, dev, 2)
    n = itab.shape[1]
    if itab.shape[0] != ITAB_ROWS or tuple(ftab.shape) != (FTAB_ROWS, n):
        raise ValueError(f"expand_pairs: itab {tuple(itab.shape)}, ftab "
                         f"{tuple(ftab.shape)}; expected [5, N] and [4, N]")
    if atab is not None:
        cuda_lib.require(atab, "atab", torch.float32, dev, 2)
        if tuple(atab.shape) != (ATAB_ROWS, n):
            raise ValueError(f"expand_pairs: atab {tuple(atab.shape)}; "
                             f"expected [{ATAB_ROWS}, {n}]")
    if not 0 <= p_out < 2**31 or n >= 2**31:
        raise ValueError(f"expand_pairs: p_out {p_out} or n {n} out of range")
    lib = cuda_lib.lib()
    out = _sentinel(p_out, num_tiles, dev, atab is not None)
    tile, depth, gid = out[:3]
    attrs = out[3] if atab is not None else None
    if p_out == 0 or n == 0:
        return out
    code = lib.tpugs_expand(
        dev.index, itab.data_ptr(), ftab.data_ptr(), n, p_out, num_tiles,
        ntx, tile_w, tile_h, tile.data_ptr(), depth.data_ptr(),
        gid.data_ptr(), None if atab is None else atab.data_ptr(),
        None if attrs is None else attrs.data_ptr(), cuda_lib.stream_ptr(dev))
    if atab is None:
        expand_pairs.launches += 1
    else:
        expand_pairs.launches_carry += 1
    cuda_lib.check("tpugs_expand", code)
    return out


expand_pairs.launches = 0
expand_pairs.launches_carry = 0

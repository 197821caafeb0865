"""Stage 2: tile binning and the depth sort, as in tpugs/ops/binning.py.

The expansion runs in the expand kernel (ops/expand.py); the sort that
follows is `torch.sort` on one int64 key per pair, as the JAX package leaves
its sort to XLA. The three sorts of the reference's kernel path:

- presorted (gaussian index == depth rank): key = tile << shift | gid;
- qkey: key = tile << qbits | quantized depth bin, unstable (viewer only);
- the 2-key (tile, depth) sort: key = tile << 32 | depth's order bits,
  stable, so ties keep the gaussian-major slot order and gid is the last
  tie-break.

tile_start/tile_stop come from a binary search of the sorted keys.
Every size is static, as the reference's: the expansion has pair_capacity
slots, those past the true total hold the sentinel tile num_tiles and sort
after every real pair, and the total, num_pairs and the overflow flag stay
on the device. Binning reads nothing back to the host, so a train step can
run as a captured CUDA graph.

Two options of the reference's kernel path:

- reduce_meta: the metadata of the classic backward reduction. exp_slot
  [P] is each sorted pair's expansion slot (the sort's permutation, in all
  three sorts); gaussian g's slots are [red_start[g], red_start[g] +
  red_count[g]) and every interval ends by exp_end. The port's expansion
  has no per-chunk padding, so these are the offsets and counts clipped to
  the pair capacity, with exp_end = pair_capacity (the static slot count),
  where the reference's are chunk positions; both truncate at the pair
  capacity.
- carry_attrs: the expand kernel's carry mode writes the nine compositor
  attributes per slot and the sort's permutation carries them into attr_c
  [11, P] (x y ca cb cc op r g b gid valid, pack.pack_compact_attrs'
  rows), bit-identical inside every tile segment to the gathered table.

Slice binning (the tile-sharded mesh path, parallel/tile_shard.py): with
num_tile_rows > 0 only the tile rows [tile_row_lo, tile_row_lo +
num_tile_rows) are binned and the result's tile ids are local to that
slice (tile 0 = its first tile). The rects are clipped to the slice's rows;
the expand kernel stays slice-agnostic and emits global tile ids, which one
elementwise pass localises, invalid slots going to the local sentinel,
before the sort. tile_row_lo is a Python int (one per rank).
"""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.ops import expand as EX
from tpugs_torch.ops import pack
from tpugs_torch.ops.projection import ProjectionOutput

F32_MAX = torch.finfo(torch.float32).max


@dataclasses.dataclass
class BinningResult:
    """Sorted (tile, gaussian) pair list + per-tile ranges.

    pair_gauss [P]  gaussian index per sorted pair
    pair_tile  [P]  tile id per sorted pair (num_tiles for invalid slots,
                    which sort to the back)
    tile_start [T]  start of each tile's run in the sorted list (int32)
    tile_stop  [T]  end of the run, exclusive (int32)
    num_pairs  []   true total pair count (may exceed the capacity), int64
    overflow   []   bool: the total exceeded the capacity (pairs dropped)
    P is the static slot count, the pair capacity: the real pairs come
    first, in tile order, then every slot of the sentinel tile.

    With reduce_meta (else None):
    exp_slot   [P]  int32 expansion slot of each sorted pair
    red_start  [N]  int32 first expansion slot of each gaussian
    red_count  [N]  int32 its slots inside the capacity
    exp_end    int  end of the expansion's slots: the pair capacity
    With carry_attrs (else None):
    attr_c     [11, P] f32 sorted attributes x y ca cb cc op r g b gid valid
    """

    pair_gauss: torch.Tensor
    pair_tile: torch.Tensor
    tile_start: torch.Tensor
    tile_stop: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    exp_slot: torch.Tensor | None = None
    red_start: torch.Tensor | None = None
    red_count: torch.Tensor | None = None
    exp_end: int | None = None
    attr_c: torch.Tensor | None = None


def tile_rects(proj: ProjectionOutput, img_w: int, img_h: int, tile_w: int,
               tile_h: int, r2_cull=None):
    """Per-gaussian touched tile rectangle -> (tx0, ty0, w_tiles, h_tiles)
    int32; culled gaussians get zero-area rects. With r2_cull the rect radius
    is min(3-sigma radius, ceil(alpha-aware radius))."""
    ntx = -(-img_w // tile_w)
    nty = -(-img_h // tile_h)
    x = proj.means2d[:, 0]
    y = proj.means2d[:, 1]
    r = proj.radii.to(torch.float32)
    if r2_cull is not None:
        r_alpha = torch.sqrt(torch.clamp(r2_cull, max=3.4e38))
        r = torch.minimum(r, torch.ceil(r_alpha))

    i32 = torch.int32
    rect_min_x = torch.clamp(torch.floor(x - r), 0, img_w).to(i32)
    rect_min_y = torch.clamp(torch.floor(y - r), 0, img_h).to(i32)
    rect_max_x = torch.clamp(torch.floor(x + r + 1.0), 0, img_w).to(i32)
    rect_max_y = torch.clamp(torch.floor(y + r + 1.0), 0, img_h).to(i32)

    tx0 = rect_min_x // tile_w
    ty0 = rect_min_y // tile_h
    tx1 = torch.clamp(-((-rect_max_x) // tile_w), max=ntx)
    ty1 = torch.clamp(-((-rect_max_y) // tile_h), max=nty)

    zero = torch.zeros_like(tx0)
    w_tiles = torch.where(proj.visible, torch.clamp(tx1 - tx0, min=0), zero)
    h_tiles = torch.where(proj.visible, torch.clamp(ty1 - ty0, min=0), zero)
    return tx0, ty0, w_tiles, h_tiles


def cull_radius_sq(proj: ProjectionOutput) -> torch.Tensor:
    """Per-gaussian squared cull radius r^2 = 2 lambda_max(Sigma) ln(255 op),
    inflated by 1.001: a pixel farther than that has alpha < 1/255."""
    a, b, c = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    h = (a - c) / 2.0
    lmin = (a + c) / 2.0 - torch.sqrt(h * h + b * b + 1e-20)
    lam_max = 1.0 / torch.clamp(lmin, min=1e-12)
    r2_alpha = 2.0 * lam_max * torch.log(torch.clamp(255.0 * proj.opac, min=1.0))
    big = torch.full_like(r2_alpha, F32_MAX)
    r2 = torch.where(lmin > 0, r2_alpha * 1.001, big)
    return torch.where(proj.visible, r2, torch.zeros_like(r2))


def presort_by_depth(proj: ProjectionOutput, quant_bits: int = 0):
    """Sort the projection front to back once per frame, making the
    gaussian index the depth rank. Returns (perm [N] int64, permuted
    ProjectionOutput).

    quant_bits = 0: a stable sort by depth, invisible gaussians last, so
    equal depths keep index order. quant_bits > 0 (render(presort="fast")):
    the reference's one packed key, depth bin << idx_bits | index, the
    depth binned linearly over the visible [min, max] into min(quant_bits,
    32 - idx_bits) bits, the last bin for the invisible; ties inside a bin
    break by index, so gaussians in distinct bins keep the exact order.
    The bins are the reference's float32 ops in its order; the key is
    int64 (the order of the reference's u32). The exact sort when the
    index takes more than 31 bits."""
    n = proj.depths.shape[0]
    idx_bits = _index_bits(n)
    if quant_bits > 0 and idx_bits <= 31:
        bits = min(quant_bits, 32 - idx_bits)
        nbins = (1 << bits) - 1  # the last bin: the invisible sentinel
        d, vis = proj.depths, proj.visible
        inf = torch.full_like(d, float("inf"))
        dmin = torch.min(torch.where(vis, d, inf))
        dmax = torch.max(torch.where(vis, d, -inf))
        scale = torch.div(torch.full_like(dmin, nbins - 1),
                          torch.clamp(dmax - dmin, min=1e-12))
        q = torch.clamp((d - dmin) * scale, 0, nbins - 1)
        # Selected before the cast: an invisible depth may be inf or NaN.
        q = torch.where(vis, q, torch.zeros_like(q)).to(torch.int64)
        q = torch.where(vis, q, torch.full_like(q, nbins))
        key = (q << idx_bits) | torch.arange(n, device=d.device)
        perm = torch.sort(key).values & ((1 << idx_bits) - 1)
    else:
        inf = torch.full_like(proj.depths, float("inf"))
        key = torch.where(proj.visible, proj.depths, inf)
        _, perm = torch.sort(key, stable=True)
    return perm, ProjectionOutput(
        means2d=proj.means2d[perm], depths=proj.depths[perm],
        conic=proj.conic[perm], radii=proj.radii[perm], rgb=proj.rgb[perm],
        opac=proj.opac[perm], visible=proj.visible[perm],
    )


def _index_bits(n: int) -> int:
    """Bits of a gaussian index below n (at least 1)."""
    return max(1, (n - 1).bit_length())


def _packed_key_shift(n: int, num_tiles: int):
    """The reference's bit budget for one u32 key (tile_id << shift | g):
    the shift, or None when tile and gaussian ids don't fit 32 bits. The
    port's keys are int64 and always fit."""
    shift = _index_bits(n)
    if num_tiles << shift <= 0xFFFFFFFF:
        return shift
    return None


def _depth_order_bits(depth: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) with the same order (IEEE total order
    for non-NaN values)."""
    i = depth.contiguous().view(torch.int32).to(torch.int64)
    i = torch.where(i < 0, i ^ 0x7FFFFFFF, i)
    return i + (1 << 31)


def sort_pairs(tile: torch.Tensor, depth: torch.Tensor, gid: torch.Tensor,
               num_tiles: int, n: int, total, pair_capacity: int,
               presorted: bool = False, qbits: int = 0,
               reduce_meta: bool = False,
               attrs: torch.Tensor | None = None) -> BinningResult:
    """Sort expanded (tile, depth, gid) slots into per-tile runs. `depth` is
    the quantized bin when qbits > 0 and unused when presorted.
    reduce_meta keeps the sort's permutation as exp_slot; attrs [9, P] (the
    expand kernel's carry mode) go through it into attr_c. total: the true
    pair count, a [] tensor on the device (or a number)."""
    dev = tile.device
    tile64 = tile.to(torch.int64)
    if presorted:
        shift = _index_bits(n)
        key = (tile64 << shift) | gid.to(torch.int64)
        skey, order = torch.sort(key)
        sorted_g = skey & ((1 << shift) - 1)
    else:
        if qbits > 0:
            shift = qbits
            low = torch.where(tile < num_tiles, depth, torch.zeros_like(depth))
            key = (tile64 << shift) | low.to(torch.int64)
            skey, order = torch.sort(key)
        else:
            shift = 32
            key = (tile64 << shift) | _depth_order_bits(depth)
            skey, order = torch.sort(key, stable=True)
        sorted_g = gid.to(torch.int64)[order]
    bounds = torch.arange(num_tiles, dtype=torch.int64, device=dev) << shift
    tile_start = torch.searchsorted(skey, bounds).to(torch.int32)
    tile_stop = torch.searchsorted(skey, bounds + (1 << shift)).to(torch.int32)
    sorted_tile = torch.clamp(skey >> shift, max=num_tiles).to(torch.int32)
    pair_gauss = sorted_g.to(torch.int32)
    num_pairs = torch.as_tensor(total, dtype=torch.int64, device=dev)
    attr_c = None
    if attrs is not None:
        attr_c = torch.cat([attrs[:, order], pair_gauss.to(torch.float32)[None],
                            (sorted_tile < num_tiles).to(torch.float32)[None]])
    return BinningResult(
        pair_gauss=pair_gauss,
        pair_tile=sorted_tile,
        tile_start=tile_start,
        tile_stop=tile_stop,
        num_pairs=num_pairs,
        overflow=num_pairs > pair_capacity,
        exp_slot=order.to(torch.int32) if reduce_meta else None,
        attr_c=attr_c,
    )


def _clip_rows(ty0, h_tiles, tile_row_lo: int, num_tile_rows: int):
    """A rect's tile rows clipped to the slice [tile_row_lo, tile_row_lo +
    num_tile_rows): (ty0, h_tiles), ty0 still global."""
    ty1 = torch.clamp(ty0 + h_tiles, max=tile_row_lo + num_tile_rows)
    ty0 = torch.clamp(ty0, min=tile_row_lo)
    return ty0, torch.clamp(ty1 - ty0, min=0)


def _expand_whole(proj: ProjectionOutput, img_w: int, img_h: int,
                  tile_w: int, tile_h: int, pair_capacity: int,
                  tile_row_lo: int, num_tile_rows: int):
    """The reference's whole-capacity expansion: pair_capacity slots, each
    owned by the gaussian a marker histogram + cumsum gives it, culled at
    its tile's nearest pixel. -> (tile id [P] (num_tiles where invalid),
    depth [P] (inf where invalid), owner [P] int64, num_tiles, n, total
    [] int64)."""
    ntx = -(-img_w // tile_w)
    nty = -(-img_h // tile_h)
    if num_tile_rows <= 0:
        tile_row_lo, num_tile_rows = 0, nty
    num_tiles = ntx * num_tile_rows
    dev = proj.means2d.device
    r2_cull = cull_radius_sq(proj)
    tx0, ty0, w_tiles, h_tiles = tile_rects(proj, img_w, img_h, tile_w,
                                            tile_h, r2_cull)
    ty0, h_tiles = _clip_rows(ty0, h_tiles, tile_row_lo, num_tile_rows)
    counts = (w_tiles * h_tiles).to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    n = counts.shape[0]
    total = counts.sum()

    slots = torch.arange(pair_capacity, dtype=torch.int64, device=dev)
    keep = offsets < pair_capacity
    ind = torch.zeros(pair_capacity, dtype=torch.int64, device=dev)
    ind.index_add_(0, offsets[keep], torch.ones_like(offsets[keep]))
    g = torch.clamp(torch.cumsum(ind, 0) - 1, 0, n - 1)
    in_range = slots < torch.clamp(total, max=pair_capacity)

    local = slots - offsets[g]
    w_g = torch.clamp(w_tiles.to(torch.int64)[g], min=1)
    tx = tx0.to(torch.int64)[g] + local % w_g
    ty = ty0.to(torch.int64)[g] + local // w_g  # global tile row
    tile_id = (ty - tile_row_lo) * ntx + tx
    gx, gy, r2_g = proj.means2d[g, 0], proj.means2d[g, 1], r2_cull[g]
    px0 = (tx * tile_w).to(torch.float32)
    py0 = (ty * tile_h).to(torch.float32)
    dx = torch.clamp(gx, min=px0, max=px0 + (tile_w - 1)) - gx
    dy = torch.clamp(gy, min=py0, max=py0 + (tile_h - 1)) - gy
    valid = in_range & (dx * dx + dy * dy <= r2_g)
    tile_id = torch.where(valid, tile_id, torch.full_like(tile_id, num_tiles))
    depth = torch.where(valid, proj.depths[g],
                        torch.full_like(gx, float("inf")))
    return tile_id, depth, g, num_tiles, n, total


def bin_gaussians(proj: ProjectionOutput, img_w: int, img_h: int, tile_w: int,
                  tile_h: int, pair_capacity: int, presorted: bool = False,
                  tile_row_lo: int = 0, num_tile_rows: int = 0
                  ) -> BinningResult:
    """The oracle: the reference's whole-capacity expansion (marker
    histogram + cumsum ownership over pair_capacity slots), then the same
    sort as the kernel path. num_tile_rows > 0: slice binning (see the
    module's docstring)."""
    tile_id, depth, g, num_tiles, n, total = _expand_whole(
        proj, img_w, img_h, tile_w, tile_h, pair_capacity, tile_row_lo,
        num_tile_rows)
    return sort_pairs(tile_id, depth, g, num_tiles, n, total, pair_capacity,
                      presorted=presorted)


@dataclasses.dataclass
class AlignedBinningResult:
    """The sorted pair list in the compositor kernels' aligned layout:
    every tile's segment starts on an `align` boundary of a [p_aligned]
    slot array, gap slots invalid.

    pair_gauss [P_al]  int32 gaussian index (0 where invalid)
    pair_valid [P_al]  bool
    tile_start [T]     int32 aligned segment starts
    tile_stop  [T]     int32 start + the tile's pair count
    num_pairs  []      true pre-cull pair count
    overflow   []      bool: the pair or the aligned capacity exceeded
    """

    pair_gauss: torch.Tensor
    pair_valid: torch.Tensor
    tile_start: torch.Tensor
    tile_stop: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor


def bin_gaussians_aligned(proj: ProjectionOutput, img_w: int, img_h: int,
                          tile_w: int, tile_h: int, pair_capacity: int,
                          p_aligned: int, align: int = 128,
                          tile_row_lo: int = 0, num_tile_rows: int = 0
                          ) -> AlignedBinningResult:
    """bin_gaussians' 2-key sort laid out straight into the aligned layout,
    as the reference's: the per-tile counts histogram (the sentinel tile
    written into a last row that is cut off), aligned starts, and one
    scatter of each sorted pair to its aligned slot (invalid pairs and
    those past p_aligned into a last slot that is cut off). Equal to
    composite.align_segments(bin_gaussians(...)) with the same p_aligned."""
    tile_id, depth, g, num_tiles, n, total = _expand_whole(
        proj, img_w, img_h, tile_w, tile_h, pair_capacity, tile_row_lo,
        num_tile_rows)
    b = sort_pairs(tile_id, depth, g, num_tiles, n, total, pair_capacity)
    dev = tile_id.device
    tcounts = torch.zeros(num_tiles + 1, dtype=torch.int64, device=dev)
    tcounts.index_add_(0, tile_id, torch.ones_like(tile_id))
    tcounts = tcounts[:num_tiles]
    padded = (tcounts + (align - 1)) // align * align
    astart = torch.cumsum(padded, 0) - padded
    aligned_total = astart[-1] + padded[-1]
    # Sorted pair s of tile t goes to astart[t] + (s - tile_start[t]).
    delta = astart - b.tile_start.to(torch.int64)
    sorted_tile = b.pair_tile.to(torch.int64)
    slots = torch.arange(sorted_tile.shape[0], device=dev)
    apos = slots + delta[torch.clamp(sorted_tile, max=num_tiles - 1)]
    keep = (sorted_tile < num_tiles) & (apos < p_aligned)
    apos = torch.where(keep, apos, torch.full_like(apos, p_aligned))
    packed = torch.zeros(p_aligned + 1, dtype=torch.int64, device=dev)
    packed[apos] = b.pair_gauss.to(torch.int64) + 1  # 0: an empty slot
    packed = packed[:p_aligned]
    return AlignedBinningResult(
        pair_gauss=torch.clamp(packed - 1, min=0).to(torch.int32),
        pair_valid=packed > 0,
        tile_start=astart.to(torch.int32),
        tile_stop=(astart + tcounts).to(torch.int32),
        num_pairs=b.num_pairs,
        overflow=b.overflow | (aligned_total > p_aligned),
    )


@dataclasses.dataclass
class ExpandInputs:
    """The expand kernel's inputs for one frame (see ops/expand.py)."""

    itab: torch.Tensor  # int32 [5, N]
    ftab: torch.Tensor  # f32 [4, N]
    p_out: int  # the static slot count: pair_capacity
    total: torch.Tensor  # [] int64 on the device: the true pair count
    num_tiles: int  # the kernel's sentinel: the whole grid's tile count
    ntx: int
    qbits: int  # depth-key bits of the qkey sort, 0 otherwise


def expand_inputs(proj: ProjectionOutput, img_w: int, img_h: int,
                  tile_w: int, tile_h: int, pair_capacity: int,
                  presorted: bool = False, quant_key_bits: int = 0,
                  tile_row_lo: int = 0, num_tile_rows: int = 0
                  ) -> ExpandInputs:
    """Per-gaussian rects, counts, offsets and cull radii for the expand
    kernel. quant_key_bits > 0 (not presorted) replaces the depth key with
    its linear bin over the visible depth range, as the reference's qkey
    path does, capped at 22 bits and at what the tile ids leave of 32.
    num_tile_rows > 0 clips the rects to that slice of tile rows; the
    kernel's tile ids stay global. The offsets are clipped to the pair
    capacity, which bounds every slot index (int32), so nothing is read
    back to the host; the total stays on the device."""
    if not 0 <= pair_capacity < 2**31:
        raise ValueError(f"pair capacity {pair_capacity}: past the int32 "
                         f"slot range")
    ntx = -(-img_w // tile_w)
    nty = -(-img_h // tile_h)
    num_tiles = ntx * nty
    r2_cull = cull_radius_sq(proj)
    tx0, ty0, w_tiles, h_tiles = tile_rects(proj, img_w, img_h, tile_w,
                                            tile_h, r2_cull)
    if num_tile_rows > 0:
        ty0, h_tiles = _clip_rows(ty0, h_tiles, tile_row_lo, num_tile_rows)
    counts = w_tiles * h_tiles
    offsets64 = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    total = (offsets64[-1] + counts[-1] if counts.shape[0] else
             torch.zeros((), dtype=torch.int64, device=counts.device))
    qbits = 0
    if quant_key_bits > 0 and not presorted:
        local_tiles = ntx * num_tile_rows if num_tile_rows > 0 else num_tiles
        qbits = max(min(quant_key_bits, 32 - local_tiles.bit_length(), 22), 0)
    depth_row = proj.depths
    if qbits > 0:
        nbins = 1 << qbits
        d, vis = proj.depths, proj.visible
        inf = torch.full_like(d, float("inf"))
        dmin = torch.min(torch.where(vis, d, inf))
        dmax = torch.max(torch.where(vis, d, -inf))
        # A true division, as the reference's (torch's scalar / tensor is a
        # reciprocal times the scalar, which rounds differently).
        scale = torch.div(torch.full_like(dmin, nbins - 1),
                          torch.clamp(dmax - dmin, min=1e-12))
        depth_row = torch.floor(torch.clamp((d - dmin) * scale, 0, nbins - 1))
    # A gaussian whose offset is at or past the capacity owns no slot, as
    # before the clip.
    offsets = torch.clamp(offsets64, max=pair_capacity).to(torch.int32)
    itab = torch.stack([offsets, counts, tx0, ty0,
                        torch.clamp(w_tiles, min=1)]).contiguous()
    ftab = torch.stack([proj.means2d[:, 0], proj.means2d[:, 1], r2_cull,
                        depth_row]).to(torch.float32).contiguous()
    return ExpandInputs(itab=itab, ftab=ftab, p_out=pair_capacity,
                        total=total, num_tiles=num_tiles, ntx=ntx, qbits=qbits)


def reduce_intervals(itab: torch.Tensor, p_out: int):
    """Each gaussian's expansion interval clipped to the p_out slots (the
    pair capacity) -> (red_start, red_count) int32 [N]."""
    off, cnt = itab[0].to(torch.int64), itab[1].to(torch.int64)
    lo = torch.clamp(off, max=p_out)
    hi = torch.clamp(off + cnt, max=p_out)
    return lo.to(torch.int32), (hi - lo).to(torch.int32)


def bin_gaussians_expand_kernel(proj: ProjectionOutput, img_w: int,
                                img_h: int, tile_w: int, tile_h: int,
                                pair_capacity: int, presorted: bool = False,
                                quant_key_bits: int = 0,
                                reduce_meta: bool = False,
                                carry_attrs: bool = False,
                                tile_row_lo: int = 0,
                                num_tile_rows: int = 0) -> BinningResult:
    """bin_gaussians with the expansion done by the expand kernel. The
    sorted segments are bit-identical to bin_gaussians' (presorted or 2-key
    sort); with quant_key_bits > 0 they hold the same pairs per tile in
    quantized-depth order, same-bin order arbitrary. reduce_meta,
    carry_attrs and slice binning (num_tile_rows > 0) as in the module's
    docstring."""
    ex = expand_inputs(proj, img_w, img_h, tile_w, tile_h, pair_capacity,
                       presorted, quant_key_bits, tile_row_lo, num_tile_rows)
    atab = None
    if carry_attrs:
        atab = pack.gaussian_attrs(proj.means2d, proj.conic, proj.rgb,
                                   proj.opac).T.contiguous()
    tile, depth, gid, *attrs = EX.expand_pairs(
        ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile_w, tile_h,
        atab)
    num_tiles = ex.num_tiles
    if num_tile_rows > 0:
        num_tiles = ex.ntx * num_tile_rows
        tile = torch.where(tile < ex.num_tiles, tile - tile_row_lo * ex.ntx,
                           torch.full_like(tile, num_tiles))
    b = sort_pairs(tile, depth, gid, num_tiles, proj.depths.shape[0],
                   ex.total, pair_capacity, presorted=presorted,
                   qbits=ex.qbits, reduce_meta=reduce_meta,
                   attrs=attrs[0] if attrs else None)
    if reduce_meta:
        b.red_start, b.red_count = reduce_intervals(ex.itab, ex.p_out)
        b.exp_end = ex.p_out
    return b


def max_pairs_per_tile(binning: BinningResult) -> torch.Tensor:
    """The longest per-tile run [] (to choose or check max_hits)."""
    return torch.max(binning.tile_stop - binning.tile_start)


def clamp_tile_segments(binning: BinningResult, max_hits: int):
    """Truncate every tile's segment to its first (front-most) max_hits
    entries. Returns (clamped BinningResult, pre-clamp max_tile_hits [])."""
    hits = binning.tile_stop - binning.tile_start
    max_tile_hits = torch.max(hits)
    stop = torch.minimum(binning.tile_stop, binning.tile_start + max_hits)
    return dataclasses.replace(binning, tile_stop=stop), max_tile_hits

"""Compositor orchestration and its gradients, as in
tpugs/ops/pallas/composite.py: _pallas_fwd, composite_tiles_pallas (the
scatter-add gradient) and composite_tiles_pallas_segred (the segment-sum
gradients).

Forward: pack the per-pair attributes in compact sorted order (or take
them as carried by binning's carry_attrs, `attr_c`), re-lay them per tile
at 128-aligned starts with the align-copy kernel, composite with the
forward kernel, and add the background as color + T * bg.

Every backward starts from r0 = (dC.bg + dL/dT_final) T_final and the
backward kernel's per-pair gradients, and ends by taking the conic gradient
back from its pre-scaled form by (-1/2, -1, -1/2), with dL/dbg =
sum dC T_final. The pair -> gaussian sum between them is one of three:

- `CompositeSegred`, sorted branch (the default): attribute-major rows, a
  mask of the slots that hold a pair (the align-copy valid row, before the
  last tile's stop) applied before the sort, the key sort by gaussian id
  and the sorted segment sum.
- `CompositeSegred`, classic branch (n >= 2^24, or SORTED_SEGRED_MIN
  raised; `segred_needs_meta`): entry-major rows gathered into the
  gaussian-major expansion order through binning's reduce_meta (each sorted
  pair's aligned slot is astart[tile] + its rank in the tile, kept when it
  lies before the tile's clamped stop; the pair sort is inverted through
  exp_slot), then the interval segment sum.
- `CompositeScatter` (the gradient of render(need_grads=False)):
  entry-major rows masked as in the sorted branch and added into their
  gaussians by the f32 id row, with index_add_ (the reference's XLA
  scatter-add); so it takes at most 2^24 gaussians.

The pre-aligned path (`CompositePre`, the reference's
composite_tiles_pallas_pre) takes binning.bin_gaussians_aligned's layout:
the attributes are gathered straight into [ATTR_ROWS, P_al] at the static
capacity `p_aligned(cfg)` (no pack, no align-copy), the forward kernel
composites them, and the backward takes the entry-major rows through
index_add_ by the int32 pair_gauss. `align_segments` is that layout's
oracle, from a compact binning.
"""
from __future__ import annotations

import torch

from tpugs_torch.device import device_constant
from tpugs_torch.ops import composite_t
from tpugs_torch.ops import pack
from tpugs_torch.ops import segreduce
from tpugs_torch.ops.rasterize_tiled import RasterConfig

# Aligned-slot count from which the segment-sum backward takes the sorted
# branch; below it, the classic one. 0, as the reference's default
# (tpugs/ops/pallas/composite.py::_SORTED_SEGRED_MIN): the classic branch
# runs by itself only from 2^24 gaussians, and tests raise this to cover it.
SORTED_SEGRED_MIN = 0
F32_EXACT_IDS = 1 << 24  # gaussian ids an f32 row holds exactly: 0 .. 2^24


def segred_needs_meta(cfg: RasterConfig, n: int) -> bool:
    """True when CompositeSegred's backward takes the classic branch and so
    needs binning's reduce_meta, as the reference's predicate: the aligned
    capacity below SORTED_SEGRED_MIN, or n >= 2^24."""
    p_al = pack.p_aligned_chunked(cfg.pair_capacity, cfg.num_tiles)
    return not (p_al >= SORTED_SEGRED_MIN and n < segreduce.MAX_N)


def _forward(cfg: RasterConfig, tile_start, tile_stop, pair_gauss, means2d,
             conic, rgb, opac, background, row_offset: int, attr_c=None):
    """-> (color [T, PIX, 3] with the background, final_T, n_contrib,
    k_last, astart, astop, aligned attributes). attr_c [11, P]: the sorted
    attributes carried by binning (carry_attrs), in place of the pack."""
    astart, astop, counts = pack.aligned_offsets(tile_start, tile_stop)
    # The aligned table is as long as the static bound for binning's slots
    # (the pair capacity), so its length needs no host read; the columns
    # past the last tile's padded end stay zero.
    slots = pair_gauss.shape[0]
    p_aligned = pack.p_aligned_chunked(slots, cfg.num_tiles)
    if attr_c is not None:
        attr_c = torch.cat([attr_c, attr_c.new_zeros(
            (pack.ATTR_ROWS - attr_c.shape[0], attr_c.shape[1]))])
    else:
        attr_c = pack.pack_compact_attrs(pair_gauss, means2d, conic, rgb,
                                         opac, slots)
    attr = pack.align_copy(attr_c, tile_start, astart, counts, p_aligned)
    color, t, nc, kl = composite_t.composite_forward(cfg, astart, astop, attr,
                                                     row_offset)
    color = color + t[..., None] * background[None, None, :]
    return color, t, nc, kl, astart, astop, attr


def composite_tiles_forward(cfg: RasterConfig, tile_start, tile_stop,
                            pair_gauss, means2d, conic, rgb, opac,
                            background, row_offset: int = 0, attr_c=None):
    """Composite the binned pairs -> (color [T, PIX, 3] with the background
    blended, final_T [T, PIX], n_contrib [T, PIX]), without gradients."""
    with torch.no_grad():
        color, t, nc, *_ = _forward(cfg, tile_start, tile_stop, pair_gauss,
                                    means2d, conic, rgb, opac, background,
                                    row_offset, attr_c)
    return color, t, nc


def _pair_mask(attr: torch.Tensor, astop: torch.Tensor) -> torch.Tensor:
    """[P_al] bool: the aligned slots that hold a pair (the valid row, and
    before the last tile's stop)."""
    cols = torch.arange(attr.shape[1], device=attr.device)
    last = astop[-1].to(torch.int64) if astop.shape[0] else 0
    return (attr[pack.VALID_ROW] > 0) & (cols < last)


def _param_grads(acc: torch.Tensor, d_color, final_t):
    """Per-gaussian sums [n, NUM_ATTR] -> (d means2d, d conic, d rgb,
    d opac, d bg)."""
    scale = device_constant(pack.CONIC_SCALE, acc.device, acc.dtype)
    d_bg = torch.einsum("tpc,tp->c", d_color, final_t)
    return acc[:, 0:2], acc[:, 2:5] * scale, acc[:, 6:9], acc[:, 5], d_bg


def _r0(d_color, d_final_t, final_t, bg):
    return (((d_color * bg).sum(-1) + d_final_t) * final_t).contiguous()


def _scatter_rows(d_rows: torch.Tensor, valid: torch.Tensor,
                  gid: torch.Tensor, n: int) -> torch.Tensor:
    """Entry-major rows [P_al, NUM_ATTR] added into their gaussians [n,
    NUM_ATTR] by index_add_ (the reference's scatter-add), the slots that
    hold no pair selected away first: unwritten ones may hold NaN."""
    gid = torch.where(valid, gid, torch.zeros_like(gid))
    rows = torch.where(valid[:, None], d_rows, d_rows.new_zeros(()))
    return rows.new_zeros((n, pack.NUM_ATTR)).index_add_(0, gid, rows)


def reduce_pair_grads(d_attr: torch.Tensor, attr: torch.Tensor,
                      astop: torch.Tensor, n: int) -> torch.Tensor:
    """Per-pair gradient rows [NUM_ATTR, P_al] -> per-gaussian sums
    [n, NUM_ATTR]. The mask comes first: slots the kernel left unwritten may
    hold NaN, and 0 * NaN would poison a sum."""
    valid = _pair_mask(attr, astop)
    key = torch.where(valid, attr[pack.GID_ROW].to(torch.int32),
                      torch.full_like(valid, segreduce.SENTINEL,
                                      dtype=torch.int32))
    masked = torch.where(valid[None, :], d_attr, torch.zeros_like(d_attr))
    return segreduce.segment_reduce_sorted(key, masked, n).T


def classic_reduce(cfg: RasterConfig, d_rows: torch.Tensor, astart,
                   tile_start, tile_stop, pair_tile, exp_slot, red_start,
                   red_count, exp_end: int, n: int) -> torch.Tensor:
    """The classic branch's reduction: entry-major rows [P_al, NUM_ATTR] ->
    per-gaussian sums [NUM_ATTR, n]. Sorted pair s of tile t sits at aligned
    slot astart[t] + (s - tile_start[t]) and holds a pair when t is a real
    tile and s lies before t's clamped stop; exp_slot takes each sorted pair
    back to its expansion slot (a scatter by a permutation, where the
    reference sorts by it), and the rows are gathered there, zero where no
    pair is, for the interval segment sum."""
    dev = d_rows.device
    p_al, p_out = d_rows.shape[0], pair_tile.shape[0]
    t = torch.clamp(pair_tile, max=cfg.num_tiles - 1).to(torch.int64)
    s = torch.arange(p_out, device=dev)
    a_s = astart.to(torch.int64)[t] + (s - tile_start.to(torch.int64)[t])
    valid = (pair_tile < cfg.num_tiles) & (s < tile_stop.to(torch.int64)[t])
    a_e = torch.empty(p_out, dtype=torch.int64, device=dev)
    a_e[exp_slot.to(torch.int64)] = torch.where(valid, a_s,
                                                torch.full_like(a_s, p_al))
    if p_al:
        rows = torch.where((a_e < p_al)[:, None],
                           d_rows[torch.clamp(a_e, max=p_al - 1)],
                           d_rows.new_zeros(()))
    else:
        rows = d_rows.new_zeros((p_out, pack.NUM_ATTR))
    return segreduce.segment_reduce(rows, red_start, red_count, exp_end, n)


class CompositeSegred(torch.autograd.Function):
    """composite_tiles_forward with the backward compositor kernel and a
    segment sum as its gradient: the sorted branch, or the classic one where
    segred_needs_meta says so, which then needs `meta` = (pair_tile,
    exp_slot, red_start, red_count, exp_end) from binning's reduce_meta.
    Differentiable inputs: means2d [N, 2], conic [N, 3], rgb [N, 3], opac
    [N], background [3]; n_contrib is not differentiable."""

    @staticmethod
    def forward(ctx, cfg, tile_start, tile_stop, pair_gauss, means2d, conic,
                rgb, opac, background, row_offset=0, meta=None, attr_c=None):
        n = means2d.shape[0]
        classic = segred_needs_meta(cfg, n)
        if classic and meta is None:
            raise ValueError(
                f"CompositeSegred: the classic backward branch (n = {n}, "
                f"SORTED_SEGRED_MIN = {SORTED_SEGRED_MIN}) needs binning's "
                f"reduce_meta; consult segred_needs_meta with the same cfg "
                f"and n")
        color, t, nc, kl, astart, astop, attr = _forward(
            cfg, tile_start, tile_stop, pair_gauss, means2d, conic, rgb, opac,
            background, row_offset, attr_c)
        saved = [astart, astop, attr, t, kl, background]
        if classic:
            saved += [tile_start, tile_stop, *meta[:4]]
            ctx.exp_end = meta[4]
        ctx.save_for_backward(*saved)
        ctx.cfg, ctx.n, ctx.row_offset = cfg, n, row_offset
        ctx.classic = classic
        ctx.mark_non_differentiable(nc)
        return color, t, nc

    @staticmethod
    def backward(ctx, d_color, d_final_t, _d_nc):
        astart, astop, attr, final_t, kl, bg, *meta = ctx.saved_tensors
        d_color = d_color.contiguous()
        r0 = _r0(d_color, d_final_t, final_t, bg)
        args = (ctx.cfg, astart, astop, attr, d_color, r0,
                final_t.contiguous(), kl, ctx.row_offset)
        if ctx.classic:
            d_rows = composite_t.composite_backward(*args, transposed_out=False)
            acc = classic_reduce(ctx.cfg, d_rows, astart, *meta, ctx.exp_end,
                                 ctx.n).T
        else:
            d_attr = composite_t.composite_backward(*args)
            acc = reduce_pair_grads(d_attr, attr, astop, ctx.n)
        d_means2d, d_conic, d_rgb, d_opac, d_bg = _param_grads(
            acc, d_color, final_t)
        return (None, None, None, None, d_means2d, d_conic, d_rgb, d_opac,
                d_bg, None, None, None)


class CompositeScatter(torch.autograd.Function):
    """composite_tiles_forward with the reference's scatter-add gradient
    (composite_tiles_pallas): the entry-major backward rows, masked to the
    slots that hold a pair, added into their gaussians by the aligned id
    row with index_add_. The ids ride an f32 row, exact up to 2^24, so it
    refuses more gaussians rather than add into wrong ones. Inputs as
    CompositeSegred's, without meta."""

    @staticmethod
    def forward(ctx, cfg, tile_start, tile_stop, pair_gauss, means2d, conic,
                rgb, opac, background, row_offset=0, attr_c=None):
        n = means2d.shape[0]
        if n > F32_EXACT_IDS:
            raise ValueError(
                f"CompositeScatter: {n} gaussians; its f32 id row is exact "
                f"only up to {F32_EXACT_IDS}: render with need_grads=True")
        color, t, nc, kl, astart, astop, attr = _forward(
            cfg, tile_start, tile_stop, pair_gauss, means2d, conic, rgb, opac,
            background, row_offset, attr_c)
        ctx.save_for_backward(astart, astop, attr, t, kl, background)
        ctx.cfg, ctx.n, ctx.row_offset = cfg, n, row_offset
        ctx.mark_non_differentiable(nc)
        return color, t, nc

    @staticmethod
    def backward(ctx, d_color, d_final_t, _d_nc):
        astart, astop, attr, final_t, kl, bg = ctx.saved_tensors
        d_color = d_color.contiguous()
        r0 = _r0(d_color, d_final_t, final_t, bg)
        d_rows = composite_t.composite_backward(
            ctx.cfg, astart, astop, attr, d_color, r0, final_t.contiguous(),
            kl, ctx.row_offset, transposed_out=False)
        acc = _scatter_rows(d_rows, _pair_mask(attr, astop),
                            attr[pack.GID_ROW].to(torch.int64), ctx.n)
        d_means2d, d_conic, d_rgb, d_opac, d_bg = _param_grads(
            acc, d_color, final_t)
        return (None, None, None, None, d_means2d, d_conic, d_rgb, d_opac,
                d_bg, None, None)


def p_aligned(cfg: RasterConfig) -> int:
    """The pre-aligned layout's capacity, the reference's _p_aligned: a
    pad of LANE_ALIGN per tile (not pack.p_aligned_chunked's LANE_ALIGN -
    1), rounded up to CHUNK, plus CHUNK."""
    raw = cfg.pair_capacity + cfg.num_tiles * pack.LANE_ALIGN
    return -(-raw // pack.CHUNK) * pack.CHUNK + pack.CHUNK


def align_segments(tile_start, tile_stop, pair_gauss, p_aligned: int):
    """The aligned layout from a compact sorted pair list (the oracle of
    bin_gaussians_aligned): every tile's segment moved to its
    pack.aligned_offsets start, gap slots invalid. Slot ownership by a
    marker histogram + cumsum over the aligned starts (a start at or past
    p_aligned goes to a last row that is cut off). -> (astart [T], astop
    [T] int32, aligned_gauss [p_aligned] int32 (0 where invalid), valid
    [p_aligned])."""
    dev = tile_start.device
    astart, astop, counts = pack.aligned_offsets(tile_start, tile_stop)
    a64, c64 = astart.to(torch.int64), counts.to(torch.int64)
    pos = torch.arange(p_aligned, device=dev)
    ind = torch.zeros(p_aligned + 1, dtype=torch.int64, device=dev)
    ind.index_add_(0, torch.clamp(a64, max=p_aligned), torch.ones_like(a64))
    t = torch.clamp(torch.cumsum(ind[:p_aligned], 0) - 1, 0,
                    counts.shape[0] - 1)
    local = pos - a64[t]
    valid = (local >= 0) & (local < c64[t])
    src = torch.clamp(pos + (tile_start.to(torch.int64) - a64)[t], 0,
                      pair_gauss.shape[0] - 1)
    aligned_gauss = torch.where(valid, pair_gauss[src].to(torch.int32),
                                torch.zeros((), dtype=torch.int32, device=dev))
    return astart, astop, aligned_gauss, valid


class CompositePre(torch.autograd.Function):
    """The compositor on the pre-aligned layout (bin_gaussians_aligned with
    p_aligned(cfg)), the reference's composite_tiles_pallas_pre.

    Forward: the nine attributes gathered by pair_gauss into
    [ATTR_ROWS, P_al] (gap slots hold gaussian 0's, rows 9.. zero, as the
    reference's), the forward compositor kernel, then + T * bg. Backward:
    r0, the backward compositor's entry-major rows, a mask of the slots
    that hold a pair (pair_valid, before the last tile's stop) applied by
    select (unwritten slots may hold NaN), and index_add_ of the rows into
    their gaussians by the int32 pair_gauss. The ids never ride an f32
    row, so this path takes any N. Differentiable inputs: means2d, conic,
    rgb, opac, background."""

    @staticmethod
    def forward(ctx, cfg, tile_start, tile_stop, pair_gauss, pair_valid,
                means2d, conic, rgb, opac, background, row_offset=0):
        p_al = pair_gauss.shape[0]
        attr = means2d.new_zeros((pack.ATTR_ROWS, p_al))
        attr[:pack.NUM_ATTR] = pack.gaussian_attrs(
            means2d, conic, rgb, opac)[pair_gauss.to(torch.int64)].T
        color, t, nc, kl = composite_t.composite_forward(
            cfg, tile_start, tile_stop, attr, row_offset)
        color = color + t[..., None] * background[None, None, :]
        ctx.save_for_backward(tile_start, tile_stop, pair_gauss, pair_valid,
                              attr, t, kl, background)
        ctx.cfg, ctx.n, ctx.row_offset = cfg, means2d.shape[0], row_offset
        ctx.mark_non_differentiable(nc)
        return color, t, nc

    @staticmethod
    def backward(ctx, d_color, d_final_t, _d_nc):
        (tile_start, tile_stop, pair_gauss, pair_valid, attr, final_t, kl,
         bg) = ctx.saved_tensors
        d_color = d_color.contiguous()
        r0 = _r0(d_color, d_final_t, final_t, bg)
        d_rows = composite_t.composite_backward(
            ctx.cfg, tile_start, tile_stop, attr, d_color, r0,
            final_t.contiguous(), kl, ctx.row_offset, transposed_out=False)
        slots = torch.arange(d_rows.shape[0], device=d_rows.device)
        acc = _scatter_rows(d_rows, pair_valid & (slots < tile_stop[-1]),
                            pair_gauss.to(torch.int64), ctx.n)
        d_means2d, d_conic, d_rgb, d_opac, d_bg = _param_grads(
            acc, d_color, final_t)
        return (None, None, None, None, None, d_means2d, d_conic, d_rgb,
                d_opac, d_bg, None)

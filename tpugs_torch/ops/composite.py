"""Compositor orchestration and its gradient, as in
tpugs/ops/pallas/composite.py::_pallas_fwd and composite_tiles_pallas_segred.

Forward: pack the per-pair attributes in compact sorted order, re-lay them
per tile at 128-aligned starts with the align-copy kernel, composite with
the forward kernel, and add the background as color + T * bg.

Backward (`CompositeSegred`, the reference's sorted-key branch of
_segred_bwd): r0 = (dC.bg + dL/dT_final) T_final, the backward kernel's
per-pair gradient rows, a mask of the slots that hold a pair (the align-copy
valid row, before the last tile's stop) applied before the sort, the key
sort by gaussian id and the sorted segment sum; then the conic gradient is
taken back from its pre-scaled form by (-1/2, -1, -1/2) and
dL/dbg = sum dC T_final.
"""
from __future__ import annotations

import torch

from tpugs_torch.ops import composite_t
from tpugs_torch.ops import pack
from tpugs_torch.ops import segreduce
from tpugs_torch.ops.rasterize_tiled import RasterConfig

CONIC_SCALE = (-0.5, -1.0, -0.5)  # pack_compact_attrs' conic pre-scale


def _forward(cfg: RasterConfig, tile_start, tile_stop, pair_gauss, means2d,
             conic, rgb, opac, background, row_offset: int):
    """-> (color [T, PIX, 3] with the background, final_T, n_contrib,
    k_last, astart, astop, aligned attributes)."""
    astart, astop, counts = pack.aligned_offsets(tile_start, tile_stop)
    p_aligned = pack.aligned_length(astart, counts)
    # Valid pairs occupy the first min(num_pairs, capacity) sorted slots.
    pg = pair_gauss[: min(pair_gauss.shape[0], cfg.pair_capacity)]
    attr_c = pack.pack_compact_attrs(pg, means2d, conic, rgb, opac,
                                     pg.shape[0])
    attr = pack.align_copy(attr_c, tile_start, astart, counts, p_aligned)
    color, t, nc, kl = composite_t.composite_forward(cfg, astart, astop, attr,
                                                     row_offset)
    color = color + t[..., None] * background[None, None, :]
    return color, t, nc, kl, astart, astop, attr


def composite_tiles_forward(cfg: RasterConfig, tile_start, tile_stop,
                            pair_gauss, means2d, conic, rgb, opac,
                            background, row_offset: int = 0):
    """Composite the binned pairs -> (color [T, PIX, 3] with the background
    blended, final_T [T, PIX], n_contrib [T, PIX]), without gradients."""
    with torch.no_grad():
        color, t, nc, *_ = _forward(cfg, tile_start, tile_stop, pair_gauss,
                                    means2d, conic, rgb, opac, background,
                                    row_offset)
    return color, t, nc


def reduce_pair_grads(d_attr: torch.Tensor, attr: torch.Tensor,
                      astop: torch.Tensor, n: int) -> torch.Tensor:
    """Per-pair gradient rows [NUM_ATTR, P_al] -> per-gaussian sums
    [n, NUM_ATTR]. The mask comes first: slots the kernel left unwritten may
    hold NaN, and 0 * NaN would poison a sum."""
    p_al = attr.shape[1]
    cols = torch.arange(p_al, device=attr.device)
    last = astop[-1].to(torch.int64) if astop.shape[0] else 0
    valid = (attr[pack.VALID_ROW] > 0) & (cols < last)
    key = torch.where(valid, attr[pack.GID_ROW].to(torch.int32),
                      torch.full_like(cols, segreduce.SENTINEL,
                                      dtype=torch.int32))
    masked = torch.where(valid[None, :], d_attr, torch.zeros_like(d_attr))
    return segreduce.segment_reduce_sorted(key, masked, n).T


class CompositeSegred(torch.autograd.Function):
    """composite_tiles_forward with the backward compositor kernel and the
    sorted segment reduction as its gradient. Differentiable inputs:
    means2d [N, 2], conic [N, 3], rgb [N, 3], opac [N], background [3];
    n_contrib is not differentiable."""

    @staticmethod
    def forward(ctx, cfg, tile_start, tile_stop, pair_gauss, means2d, conic,
                rgb, opac, background, row_offset=0):
        color, t, nc, kl, astart, astop, attr = _forward(
            cfg, tile_start, tile_stop, pair_gauss, means2d, conic, rgb, opac,
            background, row_offset)
        ctx.save_for_backward(astart, astop, attr, t, kl, background)
        ctx.cfg, ctx.n, ctx.row_offset = cfg, means2d.shape[0], row_offset
        ctx.mark_non_differentiable(nc)
        return color, t, nc

    @staticmethod
    def backward(ctx, d_color, d_final_t, _d_nc):
        astart, astop, attr, final_t, kl, bg = ctx.saved_tensors
        d_color = d_color.contiguous()
        r0 = ((d_color * bg).sum(-1) + d_final_t) * final_t
        d_attr = composite_t.composite_backward(
            ctx.cfg, astart, astop, attr, d_color, r0.contiguous(),
            final_t.contiguous(), kl, ctx.row_offset)
        acc = reduce_pair_grads(d_attr, attr, astop, ctx.n)
        scale = torch.tensor(CONIC_SCALE, dtype=acc.dtype, device=acc.device)
        d_means2d = acc[:, 0:2]
        d_conic = acc[:, 2:5] * scale
        d_opac = acc[:, 5]
        d_rgb = acc[:, 6:9]
        d_bg = torch.einsum("tpc,tp->c", d_color, final_t)
        return (None, None, None, None, d_means2d, d_conic, d_rgb, d_opac,
                d_bg, None)

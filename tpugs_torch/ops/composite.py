"""Forward compositor orchestration, as in
tpugs/ops/pallas/composite.py::_pallas_fwd: pack the per-pair attributes
in compact sorted order, re-lay them per tile at 128-aligned starts with
the align-copy kernel, composite with the forward kernel, and add the
background as color + T * bg.

Gradients through the compositor come with the training slice (the
backward kernel and the segment reduction); this slice is forward only.
"""
from __future__ import annotations

import torch

from tpugs_torch.ops import composite_t
from tpugs_torch.ops import pack
from tpugs_torch.ops.rasterize_tiled import RasterConfig


def composite_tiles_forward(cfg: RasterConfig, tile_start, tile_stop,
                            pair_gauss, means2d, conic, rgb, opac,
                            background, row_offset: int = 0):
    """Composite the binned pairs -> (color [T, PIX, 3] with the background
    blended, final_T [T, PIX], n_contrib [T, PIX])."""
    astart, astop, counts = pack.aligned_offsets(tile_start, tile_stop)
    p_aligned = pack.aligned_length(astart, counts)
    # Valid pairs occupy the first min(num_pairs, capacity) sorted slots.
    pg = pair_gauss[: min(pair_gauss.shape[0], cfg.pair_capacity)]
    attr_c = pack.pack_compact_attrs(pg, means2d, conic, rgb, opac,
                                     pg.shape[0])
    attr = pack.align_copy(attr_c, tile_start, astart, counts, p_aligned)
    color, t, nc, _ = composite_t.composite_forward(cfg, astart, astop, attr,
                                                    row_offset)
    color = color + t[..., None] * background[None, None, :]
    return color, t, nc

"""Debug checks around the compositor, as in tpugs/utils/checks.py: the
compositor consumes a hand-built pair list (segments, indices, attributes)
whose invariants the kernels assume without checking. These entry points
check them, and the output, and raise a ValueError naming the violated
invariant instead of returning garbage. The reference's checkify checks
become explicit torch checks on the same conditions; each reads one flag
back from the device, so they are for debugging (the CLIs'
--debug-checks), not for the hot path.
"""
from __future__ import annotations

import torch

from tpugs_torch.ops import binning as B
from tpugs_torch.ops.composite import composite_tiles_forward
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.rasterize_tiled import (composite_tiles_scan,
                                             tiles_to_image)


def _require(ok: torch.Tensor, what: str):
    if not bool(ok):
        raise ValueError(what)


def _input_checks(tile_start, tile_stop, pair_gauss, means2d, conic, rgb,
                  opac):
    n, p = means2d.shape[0], pair_gauss.shape[0]
    _require(torch.isfinite(means2d).all(),
             "compositor input: non-finite means2d")
    _require(torch.isfinite(conic).all(), "compositor input: non-finite conic")
    _require(torch.isfinite(rgb).all(), "compositor input: non-finite rgb")
    _require(torch.isfinite(opac).all(),
             "compositor input: non-finite opacity")
    _require(((opac >= 0.0) & (opac <= 1.0)).all(),
             "compositor input: opacity outside [0, 1]")
    _require((tile_stop >= tile_start).all(),
             "compositor input: tile segment with stop < start")
    _require(((tile_start >= 0) & (tile_stop <= p)).all(),
             "compositor input: tile segment outside the pair list")
    _require(((pair_gauss >= 0) & (pair_gauss < n)).all(),
             "compositor input: pair gaussian index out of bounds")


def checked_composite(cfg, tile_start, tile_stop, pair_gauss, means2d, conic,
                      rgb, opac, background, row_offset: int = 0,
                      compositor: str = "auto"):
    """The compositor with its input and output invariants checked ->
    (color [T, PIX, 3] with the background, final_T, n_contrib).

    compositor: "kernel" (the forward kernel K3 through its wrapper; on a
    CPU tensor its plain version), "scan" (the scan oracle), or "auto":
    the kernel on the card, the scan on the CPU."""
    if compositor == "auto":
        compositor = "kernel" if means2d.is_cuda else "scan"
    if compositor not in ("kernel", "scan"):
        raise ValueError(f"unknown compositor {compositor!r}")
    with torch.no_grad():
        _input_checks(tile_start, tile_stop, pair_gauss, means2d, conic, rgb,
                      opac)
        if compositor == "kernel":
            color, final_t, nc = composite_tiles_forward(
                cfg, tile_start, tile_stop, pair_gauss, means2d, conic, rgb,
                opac, background, row_offset)
        else:
            color, final_t, nc, _ = composite_tiles_scan(
                cfg, tile_start, tile_stop, pair_gauss, means2d, conic, rgb,
                opac, background, row_offset)
        _require(torch.isfinite(color).all(),
                 "compositor output: non-finite color")
        _require(((final_t >= 0.0) & (final_t <= 1.0)).all(),
                 "compositor output: transmittance outside [0, 1]")
    return color, final_t, nc


def checked_render(params: dict, alive, viewmat, intrinsics, cfg, sh_degree,
                   background, compositor: str = "auto"):
    """One view through projection, binning (the expand kernel's path, 2-key
    sort) and checked_composite -> the [H, W, 3] colour image."""
    with torch.no_grad():
        proj = project_gaussians(
            params["means"], params["quats"], params["log_scales"],
            params["opacity_logits"], params["sh"], alive, viewmat,
            intrinsics, cfg.img_w, cfg.img_h, sh_degree)
        binning = B.bin_gaussians_expand_kernel(
            proj, cfg.img_w, cfg.img_h, cfg.tile_w, cfg.tile_h,
            cfg.pair_capacity)
        binning, _ = B.clamp_tile_segments(binning, cfg.max_hits_per_tile)
        bg = torch.as_tensor(background, dtype=torch.float32,
                             device=proj.means2d.device)
        color_t, _, _ = checked_composite(
            cfg, binning.tile_start, binning.tile_stop, binning.pair_gauss,
            proj.means2d, proj.conic, proj.rgb, proj.opac, bg,
            compositor=compositor)
    return tiles_to_image(cfg, color_t)[: cfg.img_h, : cfg.img_w]

"""Tile geometry and the scan compositor with its analytic backward, as in
tpugs/ops/rasterize_tiled.py.

The scan compositor walks every tile's depth-sorted list one entry at a
time, all tiles in step, with the reference semantics:

- skip an entry if power > 0;
- alpha = min(opac * exp(power), 0.99); skip it if alpha < 1/255;
- a pixel composites while its transmittance before the entry is >= 1/255;
- color = sum(alpha_i T_i rgb_i) + T_final * background.

Its backward (`CompositeScan`, the reference's custom VJP) walks the same
entries in reverse: it recovers the transmittance before each entry from
final_T by division, carries the colour cotangent's suffix term as one
scalar per pixel, and adds each entry's gradient into its gaussian with
index_add_ (the reference's `.at[].add`).

It is the semantics-defining compositor of the chain dense oracle
(ops/rasterize_ref.py) -> scan -> kernels (ops/composite_t.py), which
implement the same contract on the aligned attribute layout; render()
reaches it only with compositor="scan". It reads the longest segment to
the host and loops in Python over [T, PIX] tensors, so on the card it
serves small frames only.
"""
from __future__ import annotations

import dataclasses

import torch

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_THRESHOLD = 1.0 / 255.0


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterization geometry.

    pair_capacity: most (tile, gaussian) pairs kept; past it the back-most
    pairs are dropped and the render reports pair_overflow.
    max_hits_per_tile: K, most entries composited per tile (front-most win).
    """

    img_h: int
    img_w: int
    tile_h: int = 16
    tile_w: int = 16
    pair_capacity: int = 1 << 18
    max_hits_per_tile: int = 1024

    @property
    def ntx(self) -> int:
        return -(-self.img_w // self.tile_w)

    @property
    def nty(self) -> int:
        return -(-self.img_h // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.ntx * self.nty

    @property
    def pix(self) -> int:
        return self.tile_h * self.tile_w

    @property
    def padded_h(self) -> int:
        return self.nty * self.tile_h

    @property
    def padded_w(self) -> int:
        return self.ntx * self.tile_w


def _pixel_coords(cfg: RasterConfig, device, row_offset: int = 0, tiles=None):
    """Per-tile flattened pixel coordinates: two [num_tiles, pix] float
    tensors (or [len(tiles), pix] for a subset of tile ids)."""
    t = (torch.arange(cfg.num_tiles, dtype=torch.int32, device=device)
         if tiles is None else tiles.to(device=device, dtype=torch.int32))
    tx = (t % cfg.ntx)[:, None]
    ty = (t // cfg.ntx)[:, None] + row_offset
    i = torch.arange(cfg.pix, dtype=torch.int32, device=device)[None, :]
    px = (tx * cfg.tile_w + i % cfg.tile_w).to(torch.float32)
    py = (ty * cfg.tile_h + i // cfg.tile_w).to(torch.float32)
    return px, py


def tiles_to_image(cfg: RasterConfig, tiled: torch.Tensor) -> torch.Tensor:
    """[num_tiles, pix, ...] -> [padded_h, padded_w, ...]."""
    extra = tuple(tiled.shape[2:])
    x = tiled.reshape((cfg.nty, cfg.ntx, cfg.tile_h, cfg.tile_w) + extra)
    x = x.transpose(1, 2)
    return x.reshape((cfg.padded_h, cfg.padded_w) + extra)


def image_to_tiles(cfg: RasterConfig, img: torch.Tensor) -> torch.Tensor:
    """[padded_h, padded_w, ...] -> [num_tiles, pix, ...]."""
    extra = tuple(img.shape[2:])
    x = img.reshape((cfg.nty, cfg.tile_h, cfg.ntx, cfg.tile_w) + extra)
    x = x.transpose(1, 2)
    return x.reshape((cfg.num_tiles, cfg.pix) + extra)


def _gather_entry(k: int, tile_start, tile_stop, pair_gauss, means2d, conic,
                  rgb, opac, px, py):
    """Entry k of every tile, evaluated at each of its pixels."""
    idx = tile_start + k
    valid = idx < tile_stop  # [T]
    g = pair_gauss[torch.clamp(idx, max=pair_gauss.shape[0] - 1)].to(torch.int64)
    xy, con, col, op = means2d[g], conic[g], rgb[g], opac[g]
    dx = px - xy[:, 0:1]
    dy = py - xy[:, 1:2]
    a, b, c = con[:, 0:1], con[:, 1:2], con[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    gauss = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op[:, None] * gauss
    alpha = torch.clamp(alpha_raw, max=ALPHA_CLAMP)
    passes = valid[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    return g, valid, col, dx, dy, con, gauss, alpha_raw, alpha, passes


def _scan_steps(cfg: RasterConfig, tile_start, tile_stop) -> int:
    """Entries to walk: steps past the longest segment change nothing (one
    host read)."""
    if not cfg.num_tiles:
        return 0
    return max(min(cfg.max_hits_per_tile,
                   int((tile_stop.to(torch.int64)
                        - tile_start.to(torch.int64)).max().item())), 0)


def composite_tiles_scan(cfg: RasterConfig, tile_start, tile_stop, pair_gauss,
                         means2d, conic, rgb, opac, background,
                         row_offset: int = 0):
    """Forward of the scan compositor: entry k of every tile per step, for
    k < max_hits_per_tile. Returns (color [T, PIX, 3] with the background
    blended, final_T [T, PIX], n_contrib [T, PIX] i32, k_last [T, PIX] i32)."""
    dev = means2d.device
    px, py = _pixel_coords(cfg, dev, row_offset)
    T = torch.ones((cfg.num_tiles, cfg.pix), dtype=torch.float32, device=dev)
    C = torch.zeros((cfg.num_tiles, cfg.pix, 3), dtype=torch.float32, device=dev)
    nc = torch.zeros((cfg.num_tiles, cfg.pix), dtype=torch.int32, device=dev)
    klast = torch.full((cfg.num_tiles, cfg.pix), -1, dtype=torch.int32, device=dev)
    tile_start = tile_start.to(torch.int64)
    tile_stop = tile_stop.to(torch.int64)
    for k in range(_scan_steps(cfg, tile_start, tile_stop)):
        _, _, col, *_, alpha, passes = _gather_entry(
            k, tile_start, tile_stop, pair_gauss, means2d, conic, rgb, opac,
            px, py)
        contrib = passes & (T >= T_THRESHOLD)
        a_eff = torch.where(contrib, alpha, torch.zeros_like(alpha))
        C = C + (a_eff * T)[..., None] * col[:, None, :]
        T = T * (1.0 - a_eff)
        nc = nc + contrib.to(torch.int32)
        klast = torch.where(contrib, torch.full_like(klast, k), klast)
    color = C + T[..., None] * background[None, None, :]
    return color, T, nc, klast


def _composite_backward(cfg: RasterConfig, tile_start, tile_stop, pair_gauss,
                        means2d, conic, rgb, opac, background, final_t,
                        klast, d_color, d_final_t, row_offset: int,
                        steps: int):
    """The reference's reverse walk (_composite_bwd_impl) -> gradients of
    (means2d, conic, rgb, opac, background)."""
    dev = means2d.device
    px, py = _pixel_coords(cfg, dev, row_offset)
    n = means2d.shape[0]
    tile_start = tile_start.to(torch.int64)
    tile_stop = tile_stop.to(torch.int64)
    # The suffix term per pixel, R = sum_c dC_c S_after_c + dL/dT_final T_N,
    # with S_after taking in the background blend: R starts at T_N (dC.bg +
    # dL/dT_final).
    R = (torch.einsum("tpc,c->tp", d_color, background) + d_final_t) * final_t
    T = final_t
    dm = means2d.new_zeros((n, 2))
    dcn = means2d.new_zeros((n, 3))
    drgb = means2d.new_zeros((n, 3))
    dop = means2d.new_zeros((n,))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(steps - 1, -1, -1):
        g, valid, col, dx, dy, con, gauss, alpha_raw, alpha, passes = \
            _gather_entry(k, tile_start, tile_stop, pair_gauss, means2d,
                          conic, rgb, opac, px, py)
        contrib = passes & (k <= klast)
        one_minus = torch.maximum(1.0 - alpha, torch.full_like(alpha, 1e-5))
        T = torch.where(contrib, T / one_minus, T)  # T before entry k
        w = torch.where(contrib, alpha * T, zero)
        g_rgb = torch.einsum("tp,tpc->tc", w, d_color)
        dc_dot_rgb = torch.einsum("tpc,tc->tp", d_color, col)
        g_alpha = torch.where(contrib, T * dc_dot_rgb - R / one_minus, zero)
        # The suffix takes in entry k after its own gradient used it.
        R = R + w * dc_dot_rgb
        # No opacity or position gradient where alpha hit the 0.99 clamp.
        clamp_ok = (alpha_raw < ALPHA_CLAMP).to(torch.float32)
        g_op_pix = g_alpha * gauss * clamp_ok
        g_power = g_alpha * alpha * clamp_ok
        a, b, c = con[:, 0:1], con[:, 1:2], con[:, 2:3]
        g_dx = g_power * (-(a * dx + b * dy))
        g_dy = g_power * (-(b * dx + c * dy))
        vf = valid.to(torch.float32)
        gid = torch.where(valid, g, torch.zeros_like(g))
        dm.index_add_(0, gid, torch.stack(
            [-g_dx.sum(1), -g_dy.sum(1)], -1) * vf[:, None])
        dcn.index_add_(0, gid, torch.stack(
            [(g_power * (-0.5 * dx * dx)).sum(1),
             (g_power * (-dx * dy)).sum(1),
             (g_power * (-0.5 * dy * dy)).sum(1)], -1) * vf[:, None])
        drgb.index_add_(0, gid, g_rgb * vf[:, None])
        dop.index_add_(0, gid, g_op_pix.sum(1) * vf)
    d_bg = torch.einsum("tpc,tp->c", d_color, final_t)
    return dm, dcn, drgb, dop, d_bg


class CompositeScan(torch.autograd.Function):
    """The scan compositor with the reference's analytic backward. Inputs
    as composite_tiles_scan's; outputs (color [T, PIX, 3] with the
    background, final_T [T, PIX], n_contrib [T, PIX]); differentiable in
    means2d, conic, rgb, opac and background."""

    @staticmethod
    def forward(ctx, cfg, tile_start, tile_stop, pair_gauss, means2d, conic,
                rgb, opac, background, row_offset=0):
        color, t, nc, klast = composite_tiles_scan(
            cfg, tile_start, tile_stop, pair_gauss, means2d, conic, rgb, opac,
            background, row_offset)
        ctx.save_for_backward(tile_start, tile_stop, pair_gauss, means2d,
                              conic, rgb, opac, background, t, klast)
        ctx.cfg, ctx.row_offset = cfg, row_offset
        ctx.steps = _scan_steps(cfg, tile_start, tile_stop)
        ctx.mark_non_differentiable(nc)
        return color, t, nc

    @staticmethod
    def backward(ctx, d_color, d_final_t, _d_nc):
        grads = _composite_backward(ctx.cfg, *ctx.saved_tensors, d_color,
                                    d_final_t, ctx.row_offset, ctx.steps)
        return (None, None, None, None, *grads, None)


def composite_tiles(cfg: RasterConfig, tile_start, tile_stop, pair_gauss,
                    means2d, conic, rgb, opac, background,
                    row_offset: int = 0):
    """The reference's composite_tiles: (color [T, PIX, 3] with the
    background blended, final_T [T, PIX], n_contrib [T, PIX]) in tile
    layout, differentiable through CompositeScan. row_offset: the global
    tile row of tile 0 (the tile-sharded path's slice)."""
    return CompositeScan.apply(cfg, tile_start, tile_stop, pair_gauss,
                               means2d, conic, rgb, opac, background,
                               row_offset)

"""Tile geometry and the scan compositor's forward, as in
tpugs/ops/rasterize_tiled.py.

The scan compositor walks every tile's depth-sorted list one entry at a
time, all tiles in step, with the reference semantics:

- skip an entry if power > 0;
- alpha = min(opac * exp(power), 0.99); skip it if alpha < 1/255;
- a pixel composites while its transmittance before the entry is >= 1/255;
- color = sum(alpha_i T_i rgb_i) + T_final * background.

Here it is the CPU oracle of the forward-compositor kernel
(ops/composite_t.py), which implements the same contract on the aligned
attribute layout.
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
    last = pair_gauss.shape[0] - 1
    # Steps past the longest segment change nothing; stop there.
    steps = min(cfg.max_hits_per_tile, int((tile_stop - tile_start).max().item())
                if cfg.num_tiles else 0)
    for k in range(max(steps, 0)):
        idx = tile_start + k
        valid = idx < tile_stop
        g = pair_gauss[torch.clamp(idx, max=last)].to(torch.int64)
        xy, con, col, op = means2d[g], conic[g], rgb[g], opac[g]
        dx = px - xy[:, 0:1]
        dy = py - xy[:, 1:2]
        a, b, c = con[:, 0:1], con[:, 1:2], con[:, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        gauss = torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.clamp(op[:, None] * gauss, max=ALPHA_CLAMP)
        passes = valid[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        contrib = passes & (T >= T_THRESHOLD)
        a_eff = torch.where(contrib, alpha, torch.zeros_like(alpha))
        C = C + (a_eff * T)[..., None] * col[:, None, :]
        T = T * (1.0 - a_eff)
        nc = nc + contrib.to(torch.int32)
        klast = torch.where(contrib, torch.full_like(klast, k), klast)
    color = C + T[..., None] * background[None, None, :]
    return color, T, nc, klast

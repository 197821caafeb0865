"""Forward compositor: the kernel wrapper and its plain PyTorch version, with
the contract of tpugs/ops/pallas/composite_t.py::composite_forward_pallas.

Per tile, the entries k = 0 .. num-1 of its aligned segment
[astart, astop) are walked front to back. For each pixel:

- power = ca dx^2 + cc dy^2 + cb dx dy (conic pre-scaled at pack time);
- the entry passes if power <= 0 and alpha = min(opac exp(power), 0.99)
  >= 1/255;
- it contributes if it passes and T_before >= 1/255: C += alpha T rgb,
  T *= 1 - alpha, n_contrib += 1, k_last = k.

Outputs: color before background [T, PIX, 3], final T [T, PIX], n_contrib
[T, PIX] int32 and k_last [T, PIX] int32 (-1 where nothing contributed).

The CUDA kernel is csrc/composite_fwd.cu (it replaces
tpugs/ops/pallas/composite_t.py::_fwd_kernel). A CUDA tensor goes to the
kernel, a CPU tensor to `composite_forward_plain`.
"""
from __future__ import annotations

import torch

from tpugs_torch import cuda_lib
from tpugs_torch.ops.pack import ATTR_ROWS
from tpugs_torch.ops.rasterize_tiled import (ALPHA_CLAMP, ALPHA_MIN,
                                             T_THRESHOLD, RasterConfig,
                                             _pixel_coords)

EXIT_CHECK = 64  # plain version: steps between drops of finished tiles
MAX_TILE_PIX = 16 * 256  # the kernel: 256 threads of at most 16 pixels


def composite_forward_plain(cfg: RasterConfig, astart: torch.Tensor,
                            astop: torch.Tensor, sorted_attr: torch.Tensor,
                            row_offset: int = 0, tiles: torch.Tensor | None = None):
    """Plain version: entry k of every tile per step, all tiles and pixels
    at once, with the kernel's arithmetic in the kernel's order; every
    EXIT_CHECK steps it drops the tiles with no entries or live pixels
    left. `tiles` (tile ids) restricts it to a subset; the outputs then
    have one row per listed tile."""
    dev = sorted_attr.device
    sel = (torch.arange(cfg.num_tiles, device=dev) if tiles is None
           else tiles.to(device=dev, dtype=torch.int64))
    start = astart.to(torch.int64)[sel]
    num = astop.to(torch.int64)[sel] - start
    px, py = _pixel_coords(cfg, dev, row_offset, sel)
    nt = sel.shape[0]
    T = torch.ones((nt, cfg.pix), dtype=torch.float32, device=dev)
    C = torch.zeros((nt, cfg.pix, 3), dtype=torch.float32, device=dev)
    nc = torch.zeros((nt, cfg.pix), dtype=torch.int32, device=dev)
    kl = torch.full((nt, cfg.pix), -1, dtype=torch.int32, device=dev)
    last = max(sorted_attr.shape[1] - 1, 0)
    steps = int(num.max()) if nt else 0
    for k0 in range(0, steps, EXIT_CHECK):
        # Work on the tiles that still have entries and a live pixel.
        act = torch.nonzero((k0 < num) & (T >= T_THRESHOLD).any(1)).squeeze(1)
        if act.numel() == 0:
            break
        s_, n_, px_, py_ = start[act], num[act], px[act], py[act]
        T_, C_, nc_, kl_ = T[act], C[act], nc[act], kl[act]
        for k in range(k0, min(k0 + EXIT_CHECK, steps)):
            valid = k < n_
            a = sorted_attr[:, torch.clamp(s_ + k, max=last)]  # [16, act]
            x, y, ca, cb, cc, op = (a[r][:, None] for r in range(6))
            rgb = a[6:9].T  # [act, 3]
            dx = px_ - x
            dy = py_ - y
            power = ca * (dx * dx) + cc * (dy * dy) + cb * (dx * dy)
            gauss = torch.exp(torch.clamp(power, max=0.0))
            alpha = torch.clamp(op * gauss, max=ALPHA_CLAMP)
            contrib = (valid[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
                       & (T_ >= T_THRESHOLD))
            a_eff = torch.where(contrib, alpha, torch.zeros_like(alpha))
            C_ = C_ + (a_eff * T_)[..., None] * rgb[:, None, :]
            T_ = T_ * (1.0 - a_eff)
            nc_ = nc_ + contrib.to(torch.int32)
            kl_ = torch.where(contrib, torch.full_like(kl_, k), kl_)
        T[act], C[act], nc[act], kl[act] = T_, C_, nc_, kl_
    return C, T, nc, kl


def composite_forward(cfg: RasterConfig, astart: torch.Tensor,
                      astop: torch.Tensor, sorted_attr: torch.Tensor,
                      row_offset: int = 0):
    """Composite every tile. sorted_attr [ATTR_ROWS, P_al] f32 (pack.py
    layout), astart/astop [T] int32. Returns (color [T, PIX, 3] before
    background, final_T [T, PIX], n_contrib [T, PIX], k_last [T, PIX])."""
    if sorted_attr.device.type == "cpu":
        return composite_forward_plain(cfg, astart, astop, sorted_attr,
                                       row_offset)
    dev = sorted_attr.device
    cuda_lib.require(sorted_attr, "sorted_attr", torch.float32, dev, 2)
    cuda_lib.require(astart, "astart", torch.int32, dev, 1)
    cuda_lib.require(astop, "astop", torch.int32, dev, 1)
    nt, pix = cfg.num_tiles, cfg.pix
    if sorted_attr.shape[0] != ATTR_ROWS or astart.shape[0] != nt \
            or astop.shape[0] != nt:
        raise ValueError(f"composite_forward: sorted_attr "
                         f"{tuple(sorted_attr.shape)}, {astart.shape[0]} "
                         f"starts; expected [{ATTR_ROWS}, P] and {nt}")
    if pix > MAX_TILE_PIX:
        raise ValueError(f"composite_forward: {pix}-pixel tiles; the kernel "
                         f"takes at most {MAX_TILE_PIX}")
    lib = cuda_lib.lib()
    pal = sorted_attr.shape[1]
    if nt and int(torch.max(astop)) > pal:
        raise ValueError(f"composite_forward: segments end past column {pal}")
    color = torch.empty((nt, pix, 3), dtype=torch.float32, device=dev)
    final_t = torch.empty((nt, pix), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((nt, pix), dtype=torch.int32, device=dev)
    k_last = torch.empty((nt, pix), dtype=torch.int32, device=dev)
    if nt == 0:
        return color, final_t, n_contrib, k_last
    code = lib.tpugs_composite_fwd(
        dev.index, sorted_attr.data_ptr(), pal, astart.data_ptr(),
        astop.data_ptr(), nt, cfg.ntx, cfg.tile_w, cfg.tile_h, row_offset,
        color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
        k_last.data_ptr(), cuda_lib.stream_ptr(dev))
    composite_forward.launches += 1
    cuda_lib.check("tpugs_composite_fwd", code)
    return color, final_t, n_contrib, k_last


composite_forward.launches = 0

"""The dense oracle renderer, as tpugs/ops/rasterize_ref.py: every gaussian
composited against every pixel in plain tensor ops, differentiable by
autograd. It is the first link of the correctness chain dense oracle ->
scan compositor (ops/rasterize_tiled.py, analytic backward) -> kernels
(ops/composite_t.py): autograd through it is the gradient the analytic
backwards are held to.

Semantics, the reference rasterizer's:
- one global front-to-back depth order (a stable argsort, invisible
  gaussians last);
- a gaussian composites only against pixels whose tile lies inside its
  tile rect (the integer maths of binning.tile_rects, without the cull
  radius);
- skip where power > 0; alpha = min(opac * exp(power), 0.99), skipped
  below 1/255;
- a pixel stops once its transmittance drops below 1/255 (the gaussian
  that drops it below is composited);
- color = accumulated + T_final * background.

Transmittance is the exclusive cumulative sum of log1p(-alpha) over the
depth order. It materialises [N, H, W] tensors, so it serves tests and
tiny scenes only.
"""
from __future__ import annotations

import torch

from tpugs_torch.ops.projection import ProjectionOutput
from tpugs_torch.ops.rasterize_tiled import (ALPHA_CLAMP, ALPHA_MIN,
                                             T_THRESHOLD)


def composite_dense(means2d, conic, rgb, opac, visible, depths, radii,
                    img_h: int, img_w: int, background, tile_h: int = 16,
                    tile_w: int = 16):
    """Dense front-to-back compositing -> (color [H, W, 3], final_T [H, W],
    n_contrib [H, W] int32)."""
    dev = means2d.device
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(visible, depths, inf), stable=True)
    xy, con, col, op = means2d[order], conic[order], rgb[order], opac[order]
    vis = visible[order]
    rad = radii[order].to(torch.float32)

    px = torch.arange(img_w, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(img_h, dtype=torch.float32, device=dev)[:, None]
    dx = px[None] - xy[:, 0, None, None]  # [N, H, W]
    dy = py[None] - xy[:, 1, None, None]
    a = con[:, 0, None, None]
    b = con[:, 1, None, None]
    c = con[:, 2, None, None]
    power = -0.5 * (dx * (a * dx + b * dy) + dy * (b * dx + c * dy))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    alpha = torch.minimum(op[:, None, None] * torch.exp(torch.minimum(power, zero)),
                          torch.full((), ALPHA_CLAMP, device=dev))

    # Tile-rect membership, binning.tile_rects' integer maths.
    with torch.no_grad():
        i32 = torch.int32
        x, y = xy[:, 0], xy[:, 1]
        tx0 = torch.clamp(torch.floor(x - rad), 0, img_w).to(i32) // tile_w
        ty0 = torch.clamp(torch.floor(y - rad), 0, img_h).to(i32) // tile_h
        rmx = torch.clamp(torch.floor(x + rad + 1.0), 0, img_w).to(i32)
        rmy = torch.clamp(torch.floor(y + rad + 1.0), 0, img_h).to(i32)
        tx1 = torch.clamp(-((-rmx) // tile_w), max=-(-img_w // tile_w))
        ty1 = torch.clamp(-((-rmy) // tile_h), max=-(-img_h // tile_h))
        ptx = (torch.arange(img_w, device=dev) // tile_w)[None, None, :]
        pty = (torch.arange(img_h, device=dev) // tile_h)[None, :, None]
        member = ((ptx >= tx0[:, None, None]) & (ptx < tx1[:, None, None])
                  & (pty >= ty0[:, None, None]) & (pty < ty1[:, None, None]))

    valid = vis[:, None, None] & member & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha_eff = torch.where(valid, alpha, zero)
    log1m = torch.log1p(-alpha_eff)  # alpha <= 0.99: finite
    t_before = torch.exp(torch.cumsum(log1m, dim=0) - log1m)  # exclusive
    contrib = valid & (t_before >= T_THRESHOLD)
    w = torch.where(contrib, alpha_eff * t_before, zero)  # [N, H, W]
    color = torch.einsum("nhw,nc->hwc", w, col)
    final_t = torch.exp(torch.sum(torch.where(contrib, log1m, zero), dim=0))
    n_contrib = torch.sum(contrib, dim=0).to(torch.int32)
    color = color + final_t[..., None] * background[None, None, :]
    return color, final_t, n_contrib


def render_reference(proj: ProjectionOutput, img_h: int, img_w: int,
                     background, tile_h: int = 16, tile_w: int = 16):
    """Render a projection with the dense oracle -> (color, final_T,
    n_contrib)."""
    bg = torch.as_tensor(background, dtype=torch.float32,
                         device=proj.means2d.device)
    return composite_dense(proj.means2d, proj.conic, proj.rgb, proj.opac,
                           proj.visible, proj.depths, proj.radii, img_h,
                           img_w, bg, tile_h=tile_h, tile_w=tile_w)

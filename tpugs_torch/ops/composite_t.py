"""Forward and backward compositors: the kernel wrappers and their plain
PyTorch versions, with the contracts of
tpugs/ops/pallas/composite_t.py::composite_forward_pallas and
composite_backward_pallas (attribute-major output).

Per tile, the entries k = 0 .. num-1 of its aligned segment
[astart, astop) are walked front to back. For each pixel:

- power = ca dx^2 + cc dy^2 + cb dx dy (conic pre-scaled at pack time);
- the entry passes if power <= 0 and alpha = min(opac exp(power), 0.99)
  >= 1/255;
- it contributes if it passes and T_before >= 1/255: C += alpha T rgb,
  T *= 1 - alpha, n_contrib += 1, k_last = k.

Outputs: color before background [T, PIX, 3], final T [T, PIX], n_contrib
[T, PIX] int32 and k_last [T, PIX] int32 (-1 where nothing contributed).

The backward walks each tile from its largest k_last down to entry 0 and
recovers T before each entry by division, T /= max(1 - a, 1e-5), with
a = alpha where the entry contributed (passes and k <= k_last) and 0
elsewhere; the suffix sum R, from r0 = (dC.bg + dL/dT_final) T_final, gives
dL/dalpha = T dC.rgb - R / (1 - a). The opacity and power gradients are
zero where opac * gauss >= 0.99 (the clamp). Output: the 9 per-pair
gradients (d x, d y, d ca, d cb, d cc, d opac, d r, d g, d b, with the
conic in its pre-scaled form), attribute-major [NUM_ATTR, P_al]
(transposed_out=True, the sorted reduction's input) or entry-major
[P_al, NUM_ATTR] (transposed_out=False, the scatter-add's and the interval
segment sum's); slots outside the tiles' [astart, astop) are not written.
The two layouts come from one kernel and are bit-identical under
transposition.

The CUDA kernels are csrc/composite_fwd.cu and csrc/composite_bwd.cu (they
replace tpugs/ops/pallas/composite_t.py::_fwd_kernel and _bwd_kernel in
both its layouts). A CUDA tensor goes to the kernel, a CPU tensor to the
plain version. composite_backward counts its launches per layout:
`.launches` (attribute-major) and `.launches_entry_major`.
"""
from __future__ import annotations

import torch

from tpugs_torch import cuda_lib
from tpugs_torch.ops.pack import ATTR_ROWS, NUM_ATTR
from tpugs_torch.ops.rasterize_tiled import (ALPHA_CLAMP, ALPHA_MIN,
                                             T_THRESHOLD, RasterConfig,
                                             _pixel_coords)

EXIT_CHECK = 64  # plain version: steps between drops of finished tiles
WARP = 32
SUB_H = 16  # sub-tile height
MAX_SUBTILES = 8  # the backward's cluster: the portable cluster size
ONE_MINUS_MIN = 1e-5  # floor of 1 - alpha when T is recovered by division


def subtile_geometry(tile_w: int, tile_h: int,
                     backward: bool = False) -> tuple[int, int, int, int]:
    """(gw, gh, sw, ppt): the kernels cut a tile into gw x gh sub-tiles of
    sw x 16 pixels, one block each, ppt pixels a thread. The forward: 16x16
    at one pixel a thread (256 threads), any number of them. The backward,
    whose sub-tiles of a tile form one cluster: two pixels a thread, 16x16
    sub-tiles (128 threads) where at most MAX_SUBTILES cover the tile, else
    32x16 ones (256 threads). csrc/composite_fwd.cu and
    csrc/composite_bwd.cu compute the same."""
    if not backward:
        return -(-tile_w // 16), -(-tile_h // SUB_H), 16, 1
    for sw in (16, 32):
        gw, gh = -(-tile_w // sw), -(-tile_h // SUB_H)
        if gw * gh <= MAX_SUBTILES:
            return gw, gh, sw, 2
    raise ValueError(f"{tile_w}x{tile_h} tiles need more than "
                     f"{MAX_SUBTILES} sub-tiles of 32x16")


def kernel_pixels(tile_w: int, tile_h: int, backward: bool = False,
                  device=None) -> torch.Tensor:
    """[G, warps, WARP, ppt] int64: the tile pixel (y * tile_w + x) that
    sub-tile block s, warp w, lane l holds in slot i, or -1 past the tile's
    edge. A warp holds an 8-wide patch, 4 rows a slot (8x4 at one pixel a
    thread, 8x8 at two); the warps tile the sub-tile row by row."""
    gw, gh, sw, ppt = subtile_geometry(tile_w, tile_h, backward)
    across = sw // 8
    warps = across * (SUB_H // (4 * ppt))
    s = torch.arange(gw * gh, device=device)[:, None, None, None]
    w = torch.arange(warps, device=device)[None, :, None, None]
    lane = torch.arange(WARP, device=device)[None, None, :, None]
    i = torch.arange(ppt, device=device)[None, None, None, :]
    x = (s % gw) * sw + (w % across) * 8 + lane % 8
    y = (s // gw) * SUB_H + (w // across) * (4 * ppt) + i * 4 + lane // 8
    return torch.where((x < tile_w) & (y < tile_h), y * tile_w + x,
                       torch.full_like(x, -1))


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
    background, final_T [T, PIX], n_contrib [T, PIX], k_last [T, PIX]).
    The segments' contract (0 <= astart <= astop <= P_al) is checked by the
    kernel on the card: there cuda_lib raises ValueError at the first later
    launch or check_guards() once it has run, and the kernel composites a
    violating tile as empty."""
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
    lib = cuda_lib.lib()
    pal = sorted_attr.shape[1]
    color = torch.empty((nt, pix, 3), dtype=torch.float32, device=dev)
    final_t = torch.empty((nt, pix), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((nt, pix), dtype=torch.int32, device=dev)
    k_last = torch.empty((nt, pix), dtype=torch.int32, device=dev)
    if nt == 0:
        return color, final_t, n_contrib, k_last
    order = heaviest_first(astop - astart)
    code = lib.tpugs_composite_fwd(
        dev.index, sorted_attr.data_ptr(), pal, astart.data_ptr(),
        astop.data_ptr(), order.data_ptr(), nt, cfg.ntx, cfg.tile_w,
        cfg.tile_h, row_offset, color.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), k_last.data_ptr(),
        cuda_lib.guard_word("tpugs_composite_fwd"), cuda_lib.stream_ptr(dev))
    composite_forward.launches += 1
    cuda_lib.check("tpugs_composite_fwd", code)
    return color, final_t, n_contrib, k_last


composite_forward.launches = 0


def heaviest_first(work: torch.Tensor) -> torch.Tensor:
    """[T] int32: the tiles by descending `work` (the forward: entry
    counts; the backward: the largest k_last, its walk), the order in which
    the kernels' blocks take them. A schedule only: any order gives the
    same result. Computed on the card, without a host read."""
    return torch.argsort(work, descending=True).to(torch.int32)


def _block_sum(v: torch.Tensor, warps: int, ppt: int) -> torch.Tensor:
    """Sum [..., G * warps * WARP * ppt] over the last axis, laid out as
    [G, warps, WARP, ppt] (kernel_pixels' order), in the backward kernel's
    order: each thread adds its ppt slots in order, a warp adds its lanes
    by the shuffle-down tree (lane l takes lane l + 16, 8, 4, 2, 1; the
    kernel's transposing butterfly pairs the same lanes), a block adds its
    warps' sums in order, and the cluster adds its blocks' sums in rank
    order."""
    v = v.reshape(v.shape[:-1] + (-1, warps, WARP, ppt))
    s = v[..., 0]
    for i in range(1, ppt):
        s = s + v[..., i]
    off = WARP // 2
    while off:
        s = s[..., :off] + s[..., off:2 * off]
        off //= 2
    s = s[..., 0]
    blk = s[..., 0]
    for w in range(1, warps):
        blk = blk + s[..., w]
    tot = blk[..., 0]
    for b in range(1, blk.shape[-1]):
        tot = tot + blk[..., b]
    return tot


def composite_backward_plain(cfg: RasterConfig, astart: torch.Tensor,
                             astop: torch.Tensor, attr: torch.Tensor,
                             d_color_t: torch.Tensor, r0: torch.Tensor,
                             final_t: torch.Tensor, k_last: torch.Tensor,
                             row_offset: int = 0,
                             tiles: torch.Tensor | None = None,
                             transposed_out: bool = True) -> torch.Tensor:
    """Plain version: entry k of every tile per step, from the frame's
    largest k_last down to 0, all tiles and pixels at once, with the
    kernel's arithmetic and summation order; every EXIT_CHECK steps it takes
    in the tiles whose walk has begun. `tiles` restricts it to a subset;
    the other tiles' columns stay zero. Returns [NUM_ATTR, P_al] (or its
    transpose [P_al, NUM_ATTR] with transposed_out=False), zero outside the
    walked entries."""
    out = _backward_plain_rows(cfg, astart, astop, attr, d_color_t, r0,
                               final_t, k_last, row_offset, tiles)
    return out if transposed_out else out.T.contiguous()


def _backward_plain_rows(cfg, astart, astop, attr, d_color_t, r0, final_t,
                         k_last, row_offset, tiles) -> torch.Tensor:
    dev = attr.device
    pal = attr.shape[1]
    sel = (torch.arange(cfg.num_tiles, device=dev) if tiles is None
           else tiles.to(device=dev, dtype=torch.int64))
    start = astart.to(torch.int64)[sel]
    num = astop.to(torch.int64)[sel] - start
    px, py = _pixel_coords(cfg, dev, row_offset, sel)
    nt = sel.shape[0]
    # Pixels in the kernel's slot order (kernel_pixels); a slot past the
    # tile's edge holds a pixel with k_last -1 that never contributes.
    slots = kernel_pixels(cfg.tile_w, cfg.tile_h, True, dev)
    warps, ppt = slots.shape[1], slots.shape[3]
    slots = slots.flatten()
    past = slots < 0
    slots = slots.clamp(min=0)

    def padded(x, value):
        x = x[:, slots]
        return torch.where(past, torch.full_like(x, value), x)

    px, py = padded(px, 0.0), padded(py, 0.0)
    T = padded(final_t[sel].to(torch.float32), 1.0)
    R = padded(r0[sel].to(torch.float32), 0.0)
    dc = [padded(d_color_t[sel][..., c].to(torch.float32), 0.0)
          for c in range(3)]
    kl = padded(k_last[sel].to(torch.int64), -1)
    out = torch.zeros((NUM_ATTR, pal), dtype=torch.float32, device=dev)
    if nt == 0 or pal == 0:
        return out
    kmax = torch.minimum(kl.max(1).values, num - 1)
    top = int(kmax.max())
    for k0 in range(top, -1, -EXIT_CHECK):
        k_end = max(k0 - EXIT_CHECK, -1)
        act = torch.nonzero(kmax >= k_end + 1).squeeze(1)
        s_, km_, px_, py_, kl_ = start[act], kmax[act], px[act], py[act], kl[act]
        T_, R_ = T[act], R[act]
        dcr, dcg, dcb = (d[act] for d in dc)
        for k in range(k0, k_end, -1):
            col = torch.clamp(s_ + k, max=pal - 1)
            a_ = attr[:NUM_ATTR, col]  # [9, act]
            x, y, ca, cb, cc, op, cr, cg, cbl = (a_[r][:, None] for r in range(9))
            dx = px_ - x
            dy = py_ - y
            power = ca * (dx * dx) + cc * (dy * dy) + cb * (dx * dy)
            gauss = torch.exp(torch.clamp(power, max=0.0))
            alpha_raw = op * gauss
            alpha = torch.clamp(alpha_raw, max=ALPHA_CLAMP)
            contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & (k <= kl_)
            zero = torch.zeros_like(alpha)
            a = torch.where(contrib, alpha, zero)
            om = torch.clamp(1.0 - a, min=ONE_MINUS_MIN)
            T_ = T_ / om
            dcdot = dcr * cr + dcg * cg + dcb * cbl
            w = a * T_
            g_alpha = torch.where(contrib, T_ * dcdot - R_ / om, zero)
            R_ = R_ + w * dcdot
            clamp_ok = alpha_raw < ALPHA_CLAMP
            g_op = torch.where(clamp_ok, g_alpha * gauss, zero)
            g_pow = torch.where(clamp_ok, g_alpha * alpha, zero)
            terms = torch.stack([
                g_pow * ((2.0 * ca) * dx + cb * dy),
                g_pow * (cb * dx + (2.0 * cc) * dy),
                g_pow * (dx * dx),
                g_pow * (dx * dy),
                g_pow * (dy * dy),
                g_op,
                w * dcr,
                w * dcg,
                w * dcb,
            ])  # [9, act, G * warps * WARP * ppt]
            g = _block_sum(terms, warps, ppt)
            g[:2] = -g[:2]
            walked = k <= km_
            out[:, (s_ + k)[walked]] = g[:, walked]
        T[act], R[act] = T_, R_
    return out


def composite_backward(cfg: RasterConfig, astart: torch.Tensor,
                       astop: torch.Tensor, attr: torch.Tensor,
                       d_color_t: torch.Tensor, r0: torch.Tensor,
                       final_t: torch.Tensor, k_last: torch.Tensor,
                       row_offset: int = 0,
                       transposed_out: bool = True) -> torch.Tensor:
    """Per-pair gradients of every tile. attr [ATTR_ROWS, P_al] f32 (the
    forward's aligned table), astart/astop [T] int32, d_color_t [T, PIX, 3],
    r0 and final_t [T, PIX] f32, k_last [T, PIX] int32 (the forward's).
    Returns [NUM_ATTR, P_al] f32 (transposed_out=True) or [P_al, NUM_ATTR]
    (False); slots outside [astart, astop) are not written by the kernel.
    The segments' contract is checked on the card, as composite_forward's:
    a violating tile is walked as empty."""
    if attr.device.type == "cpu":
        return composite_backward_plain(cfg, astart, astop, attr, d_color_t,
                                        r0, final_t, k_last, row_offset,
                                        transposed_out=transposed_out)
    dev = attr.device
    nt, pix = cfg.num_tiles, cfg.pix
    cuda_lib.require(attr, "attr", torch.float32, dev, 2)
    cuda_lib.require(astart, "astart", torch.int32, dev, 1)
    cuda_lib.require(astop, "astop", torch.int32, dev, 1)
    cuda_lib.require(d_color_t, "d_color_t", torch.float32, dev, 3)
    for name, t, dt in (("r0", r0, torch.float32),
                        ("final_t", final_t, torch.float32),
                        ("k_last", k_last, torch.int32)):
        cuda_lib.require(t, name, dt, dev, 2)
        if tuple(t.shape) != (nt, pix):
            raise ValueError(f"composite_backward: {name} {tuple(t.shape)}, "
                             f"expected ({nt}, {pix})")
    if attr.shape[0] != ATTR_ROWS or astart.shape[0] != nt \
            or astop.shape[0] != nt or tuple(d_color_t.shape) != (nt, pix, 3):
        raise ValueError(f"composite_backward: attr {tuple(attr.shape)}, "
                         f"{astart.shape[0]} starts, d_color_t "
                         f"{tuple(d_color_t.shape)}; expected [{ATTR_ROWS}, P],"
                         f" {nt} and ({nt}, {pix}, 3)")
    subtile_geometry(cfg.tile_w, cfg.tile_h, True)  # raises past 8x 32x16
    lib = cuda_lib.lib()
    pal = attr.shape[1]
    shape = (NUM_ATTR, pal) if transposed_out else (pal, NUM_ATTR)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if nt == 0:
        return out
    order = heaviest_first(k_last.amax(1))
    code = lib.tpugs_composite_bwd(
        dev.index, attr.data_ptr(), pal, astart.data_ptr(), astop.data_ptr(),
        order.data_ptr(), nt, cfg.ntx, cfg.tile_w, cfg.tile_h, row_offset,
        d_color_t.data_ptr(), r0.data_ptr(), final_t.data_ptr(),
        k_last.data_ptr(), out.data_ptr(), int(not transposed_out),
        cuda_lib.guard_word("tpugs_composite_bwd"), cuda_lib.stream_ptr(dev))
    if transposed_out:
        composite_backward.launches += 1
    else:
        composite_backward.launches_entry_major += 1
    cuda_lib.check("tpugs_composite_bwd", code)
    return out


composite_backward.launches = 0
composite_backward.launches_entry_major = 0

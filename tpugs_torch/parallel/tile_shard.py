"""Tile-sharded rasterization, as tpugs/parallel/tile_shard.py: the
gaussians and the tile grid are both sharded over the mesh's "gauss" axis,
the views over "data".

Per rank, per frame:
  1. project the local shard (N/G gaussians);
  2. find each local gaussian's touched tile rect and the contiguous range
     of ranks whose tile-row slice it overlaps;
  3. pack its screen-space record (12 floats: x y depth conic3 radius rgb3
     opac valid) into a [G, C, 12] send buffer, C slots per destination,
     and all_to_all it over the gauss group (parallel/comm.py);
  4. bin only the rank's tile-row slice of the received working set: the
     depth presort, then slice binning through the expand kernel
     (ops/binning.py, num_tile_rows = rows/G), then clamp_tile_segments;
  5. composite the local tiles in global pixel coordinates
     (row_offset = the slice's first tile row) through CompositeSegred:
     the align-copy and forward compositor kernels, and in the backward
     the backward compositor with the sorted segment sum (or, from 2^24
     received records, the classic branch);
     with compositor="scan", the reference's scan branch in place of 4-5:
     the whole-capacity slice binning (binning.bin_gaussians) and the
     scan compositor with its analytic backward, an oracle with no kernel;
  6. all_gather the colour tile rows, so every rank of the data row holds
     the whole image for the L1 + SSIM loss.

The backward runs back through them: the reverse all_to_all returns each
record's gradient to its owner, and autograd's gather backward sums it
into the local gaussians. The gradient's normalisation is parallel/comm.py's.
"""
from __future__ import annotations

import torch

from tpugs_torch.ops import binning as B
from tpugs_torch.ops import composite as C
from tpugs_torch.ops.projection import ProjectionOutput, project_gaussians
from tpugs_torch.ops.rasterize_tiled import (RasterConfig, composite_tiles,
                                             tiles_to_image)
from tpugs_torch.optim.adam import AdamConfig, adam_step
from tpugs_torch.parallel import comm
from tpugs_torch.parallel.mesh import Mesh
from tpugs_torch.train.loss import combined_loss

# Exchange record: x, y, depth, conic a b c, radius, r, g, b, opac, valid.
EXCHANGE_ATTRS = 12

# A rank's pair capacity is ceil(global / G) times this: tile rows are not
# equally loaded.
PAIR_IMBALANCE_HEADROOM = 1.5


def default_local_pair_capacity(pair_capacity: int, g: int) -> int:
    return int(-(-pair_capacity // g) * PAIR_IMBALANCE_HEADROOM)


def rows_per_device(raster: RasterConfig, g: int) -> int:
    """Tile rows per rank (the grid padded up to a multiple of G rows)."""
    return -(-raster.nty // g)


def local_raster_config(raster: RasterConfig, g: int,
                        local_pair_capacity: int) -> RasterConfig:
    """A rank's slice: the same tiles and width, rows/G tile rows, its own
    pair capacity."""
    rpd = rows_per_device(raster, g)
    return RasterConfig(
        img_h=rpd * raster.tile_h, img_w=raster.img_w, tile_h=raster.tile_h,
        tile_w=raster.tile_w, pair_capacity=local_pair_capacity,
        max_hits_per_tile=raster.max_hits_per_tile)


def _pack_attrs(proj: ProjectionOutput) -> torch.Tensor:
    """[N_loc, 12] exchange records (see EXCHANGE_ATTRS)."""
    return torch.cat([
        proj.means2d, proj.depths[:, None], proj.conic,
        proj.radii.to(torch.float32)[:, None], proj.rgb, proj.opac[:, None],
        proj.visible.to(torch.float32)[:, None]], dim=1)


def _unpack_attrs(recv: torch.Tensor) -> ProjectionOutput:
    """Inverse of _pack_attrs on the received [M, 12] working set."""
    visible = recv[:, 11] > 0.5
    radii = torch.where(visible, recv[:, 6], torch.zeros_like(recv[:, 6]))
    return ProjectionOutput(
        means2d=recv[:, 0:2], depths=recv[:, 2], conic=recv[:, 3:6],
        radii=radii.detach().to(torch.int32), rgb=recv[:, 7:10],
        opac=recv[:, 10], visible=visible)


def destination_range(proj: ProjectionOutput, raster: RasterConfig, g: int):
    """Per gaussian, the contiguous range [d0, d1] (inclusive) of ranks
    whose tile rows its rect touches; an empty rect gets d0 = G, d1 = -1."""
    rpd = rows_per_device(raster, g)
    _, ty0, w_tiles, h_tiles = B.tile_rects(proj, raster.img_w, raster.img_h,
                                            raster.tile_w, raster.tile_h)
    nonempty = proj.visible & (w_tiles > 0) & (h_tiles > 0)
    d0 = torch.div(ty0, rpd, rounding_mode="floor")
    d1 = torch.div(ty0 + torch.clamp(h_tiles, min=1) - 1, rpd,
                   rounding_mode="floor")
    d0 = torch.where(nonempty, d0, torch.full_like(d0, g))
    d1 = torch.where(nonempty, d1, torch.full_like(d1, -1))
    return d0, d1


def build_send_index(d0, d1, g: int, capacity: int):
    """[G, C] local gaussian indices per destination (N_loc where a slot
    is empty) and the true counts per destination [G] (a count past C
    means slots were dropped). A gaussian past the capacity is written to
    slot C of a [C + 1] row, which is cut off: never into slot C - 1."""
    n_loc = d0.shape[0]
    dev = d0.device
    dst = torch.arange(g, device=dev)[:, None]
    mask = (d0[None, :] <= dst) & (dst <= d1[None, :])  # [G, N_loc]
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    slot = torch.where(mask & (pos < capacity), pos,
                       torch.full_like(pos, capacity)).to(torch.int64)
    flat = (slot + dst * (capacity + 1)).reshape(-1)
    idx = torch.arange(n_loc, dtype=torch.int64, device=dev).repeat(g)
    rows = torch.full((g * (capacity + 1),), n_loc, dtype=torch.int64,
                      device=dev)
    rows[flat] = idx
    send_idx = rows.reshape(g, capacity + 1)[:, :capacity]
    return send_idx, mask.sum(dim=1)


def exchange_and_render_local(proj: ProjectionOutput, raster: RasterConfig,
                              local_cfg: RasterConfig, mesh: Mesh,
                              send_capacity: int, background,
                              compositor: str = "auto",
                              need_grads: bool = True):
    """The tile-shard core on one rank: exchange the screen-space records
    with the ranks that own their tiles, bin and composite this rank's tile
    slice. Returns (color tiles [T_loc, PIX, 3], final_T, n_contrib, diag);
    differentiable in proj's float fields. compositor: "auto" or "kernel"
    (the kernels, on both devices; the reference's "auto" takes the scan
    off the TPU) or "scan" (the reference's scan branch; need_grads is
    then ignored). need_grads=False (forward-only callers) builds no
    reduction metadata and no graph."""
    if compositor not in ("auto", "kernel", "scan"):
        raise ValueError(f"unknown compositor {compositor!r}")
    g = mesh.gauss
    rpd = rows_per_device(raster, g)
    row_lo = mesh.gauss_index * rpd
    with torch.no_grad():
        d0, d1 = destination_range(proj, raster, g)
        send_idx, send_counts = build_send_index(d0, d1, g, send_capacity)
    attrs = _pack_attrs(proj)
    attrs = torch.cat([attrs, attrs.new_zeros((1, EXCHANGE_ATTRS))])
    send = attrs[send_idx]  # [G, C, 12]
    recv = comm.all_to_all(send, mesh, "gauss")  # recv[j]: what rank j sent
    work = _unpack_attrs(recv.reshape(g * send_capacity, EXCHANGE_ATTRS))
    # Ties in depth keep the received slot order (a stable presort).
    work = B.presort_by_depth(work)[1]
    n_work = work.means2d.shape[0]
    reduce_meta = need_grads and C.segred_needs_meta(local_cfg, n_work)
    with torch.no_grad():
        if compositor == "scan":
            binning = B.bin_gaussians(
                work, raster.img_w, raster.img_h, raster.tile_w,
                raster.tile_h, local_cfg.pair_capacity, presorted=True,
                tile_row_lo=row_lo, num_tile_rows=rpd)
        else:
            binning = B.bin_gaussians_expand_kernel(
                work, raster.img_w, raster.img_h, raster.tile_w,
                raster.tile_h, local_cfg.pair_capacity, presorted=True,
                reduce_meta=reduce_meta, tile_row_lo=row_lo,
                num_tile_rows=rpd)
        binning, max_tile_hits = B.clamp_tile_segments(
            binning, local_cfg.max_hits_per_tile)
    b = binning
    bg = torch.as_tensor(background, dtype=torch.float32,
                         device=work.means2d.device)
    args = (local_cfg, b.tile_start, b.tile_stop, b.pair_gauss,
            work.means2d, work.conic, work.rgb, work.opac, bg, row_lo)
    if compositor == "scan":
        color_t, final_t, nc_t = composite_tiles(*args)
    elif need_grads:
        meta = ((b.pair_tile, b.exp_slot, b.red_start, b.red_count,
                 b.exp_end) if reduce_meta else None)
        color_t, final_t, nc_t = C.CompositeSegred.apply(*args, meta, None)
    else:
        color_t, final_t, nc_t = C.composite_tiles_forward(*args)
    diag = {
        "send_overflow": torch.any(send_counts > send_capacity),
        "max_send_count": torch.max(send_counts),
        "pair_overflow": b.overflow,
        "num_pairs": b.num_pairs,
        "max_tile_hits": max_tile_hits,
    }
    return color_t, final_t, nc_t, diag


def assemble_image(raster: RasterConfig, mesh: Mesh, color_t):
    """The data row's colour tile rows gathered -> the whole [H, W, 3]
    image, on every rank of the row."""
    g = mesh.gauss
    rpd = rows_per_device(raster, g)
    full_t = comm.all_gather(color_t, mesh, "gauss")
    pad_cfg = RasterConfig(img_h=g * rpd * raster.tile_h, img_w=raster.img_w,
                           tile_h=raster.tile_h, tile_w=raster.tile_w)
    return tiles_to_image(pad_cfg, full_t)[: raster.img_h, : raster.img_w]


def _local_view(images, viewmats, intrinsics, d: int):
    """The rank's one view of its data row (its block from shard_batch)."""
    if images.shape[0] != 1:
        raise ValueError(
            f"one view per data row ({d} in all): this rank got "
            f"{images.shape[0]}; use dist_train.make_dist_train_step for "
            f"training")
    return images[0], viewmats[0], intrinsics[0]


def make_tile_sharded_train_step(mesh: Mesh, raster: RasterConfig,
                                 adam_cfg: AdamConfig = AdamConfig(),
                                 lambda_ssim: float = 0.2, sh_degree: int = 0,
                                 compositor: str = "auto",
                                 send_capacity: int | None = None,
                                 local_pair_capacity: int | None = None):
    """A train step with params, moments and tiles sharded over "gauss" and
    views over "data":

      step_fn(params, alive, adam_state, images [1,H,W,3], viewmats
              [1,4,4], intrinsics [1,4], step) -> (params, adam_state, loss)

    on each rank's shard (shard_gauss_state) and its data row's view
    (sharded_train.shard_batch). compositor: exchange_and_render_local's.
    send_capacity: exchange slots per (source, destination), default N_loc
    (never overflows); local_pair_capacity: default ceil(pair_capacity / G)
    x headroom."""
    g = mesh.gauss
    if local_pair_capacity is None:
        local_pair_capacity = default_local_pair_capacity(
            raster.pair_capacity, g)
    local_cfg = local_raster_config(raster, g, local_pair_capacity)

    def step_fn(params, alive, adam_state, images, viewmats, intrinsics,
                step):
        image, viewmat, intr = _local_view(images, viewmats, intrinsics,
                                           mesh.data)
        cap = send_capacity if send_capacity is not None else alive.shape[0]
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        proj = project_gaussians(p["means"], p["quats"], p["log_scales"],
                                 p["opacity_logits"], p["sh"], alive, viewmat,
                                 intr, raster.img_w, raster.img_h, sh_degree)
        color_t, _, _, _ = exchange_and_render_local(
            proj, raster, local_cfg, mesh, cap,
            torch.zeros(3, device=image.device), compositor)
        color = assemble_image(raster, mesh, color_t)
        loss = combined_loss(color, image, lambda_ssim)
        names = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            grads = comm.mean_over_data(dict(zip(names, grads)), mesh)
            loss = comm.all_reduce(loss.detach(), mesh, "data", "mean")
            new_params, new_adam = adam_step(adam_cfg, adam_state, params,
                                             grads, step)
        return new_params, new_adam, loss

    return step_fn


def comm_report(raster: RasterConfig, g: int, n_total: int,
                send_capacity: int, max_send_count: int,
                num_pairs: int) -> dict:
    """Analytic per-rank bytes of one frame's exchange and colour gather,
    against gauss_shard's all-gather of every attribute."""
    n_loc = n_total // g
    a2a_sent = g * send_capacity * EXCHANGE_ATTRS * 4
    allgather_recv = n_total * 11 * 4  # gauss_shard: 11 attrs, full N
    rpd = rows_per_device(raster, g)
    color_gather = g * rpd * raster.ntx * raster.pix * 3 * 4
    return {
        "all_to_all_bytes_per_device": a2a_sent,
        "all_to_all_padding_frac": 1.0 - min(
            1.0, (max_send_count or 1) / float(send_capacity)),
        "color_all_gather_bytes": color_gather,
        "gauss_shard_all_gather_bytes": allgather_recv,
        "pairs_per_device": num_pairs,
        "n_local": n_loc,
    }

"""Gaussian-sharded training, as tpugs/parallel/gauss_shard.py (kept as
the simpler design beside tile_shard.py): params and Adam moments sharded
over the mesh's "gauss" axis, views over "data". Each rank projects its
shard, all_gathers the screen-space records of its data row (12 floats a
gaussian, tile_shard's exchange record) and renders the whole image from
the gathered set through the port's render path (the expand, align-copy
and forward compositor kernels; the backward compositor and the segment
sum in the backward). The gather's backward returns each rank its slice
of the gradient (parallel/comm.py); the mean over the data group is the
normalised gradient."""
from __future__ import annotations

import torch

from tpugs_torch.ops import binning as B
from tpugs_torch.ops import composite as C
from tpugs_torch.ops.projection import ProjectionOutput, project_gaussians
from tpugs_torch.ops.rasterize_tiled import RasterConfig, tiles_to_image
from tpugs_torch.optim.adam import AdamConfig, AdamState, adam_step
from tpugs_torch.parallel import comm
from tpugs_torch.parallel.mesh import Mesh
from tpugs_torch.parallel.tile_shard import (_local_view, _pack_attrs,
                                             _unpack_attrs)
from tpugs_torch.train.loss import combined_loss


def _render_from_full(proj: ProjectionOutput, cfg: RasterConfig, background):
    """The whole image from the gathered records: the 2-key (tile, depth)
    sort, as tpugs' bin_gaussians, and the segment-sum compositor."""
    n = proj.means2d.shape[0]
    reduce_meta = C.segred_needs_meta(cfg, n)
    with torch.no_grad():
        b = B.bin_gaussians_expand_kernel(
            proj, cfg.img_w, cfg.img_h, cfg.tile_w, cfg.tile_h,
            cfg.pair_capacity, reduce_meta=reduce_meta)
        b, _ = B.clamp_tile_segments(b, cfg.max_hits_per_tile)
    meta = ((b.pair_tile, b.exp_slot, b.red_start, b.red_count, b.exp_end)
            if reduce_meta else None)
    color_t, _, _ = C.CompositeSegred.apply(
        cfg, b.tile_start, b.tile_stop, b.pair_gauss, proj.means2d,
        proj.conic, proj.rgb, proj.opac, background, 0, meta, None)
    return tiles_to_image(cfg, color_t)[: cfg.img_h, : cfg.img_w]


def make_gauss_sharded_train_step(mesh: Mesh, raster: RasterConfig,
                                  adam_cfg: AdamConfig = AdamConfig(),
                                  lambda_ssim: float = 0.2,
                                  sh_degree: int = 0):
    """step_fn(params, alive, adam_state, images [1,H,W,3], viewmats
    [1,4,4], intrinsics [1,4], step) -> (params, adam_state, loss) on this
    rank's shard (shard_gauss_state) and its data row's view
    (sharded_train.shard_batch)."""

    def step_fn(params, alive, adam_state, images, viewmats, intrinsics,
                step):
        image, viewmat, intr = _local_view(images, viewmats, intrinsics,
                                           mesh.data)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        proj = project_gaussians(p["means"], p["quats"], p["log_scales"],
                                 p["opacity_logits"], p["sh"], alive, viewmat,
                                 intr, raster.img_w, raster.img_h, sh_degree)
        full = _unpack_attrs(comm.all_gather(_pack_attrs(proj), mesh, "gauss"))
        color = _render_from_full(full, raster,
                                  torch.zeros(3, device=image.device))
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


def shard_rows(mesh: Mesh, x):
    """This rank's gauss shard (rows [i N/G, (i+1) N/G)) of a global array,
    on its device."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.gauss:
        raise ValueError(f"{n} rows do not split over gauss={mesh.gauss}")
    k = n // mesh.gauss
    return x[mesh.gauss_index * k:(mesh.gauss_index + 1) * k].to(mesh.device)


def shard_gauss_state(mesh: Mesh, params: dict, alive, adam_state: AdamState):
    """The global gaussian state's shard for this rank: params, alive and
    the moments by rows, the step count whole."""
    rows = lambda tree: {k: shard_rows(mesh, v) for k, v in tree.items()}
    return rows(params), shard_rows(mesh, alive), AdamState(
        m=rows(adam_state.m), v=rows(adam_state.v),
        count=torch.as_tensor(adam_state.count).to(mesh.device))

"""Top-level render(): projection -> binning -> compositing, as in
tpugs/ops/render.py on its kernel branch, forward only.

On a CUDA tensor every stage with a kernel launches it (expand, align-copy,
forward compositor); on a CPU tensor the same stages run their plain
PyTorch versions.
"""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.ops import binning as B
from tpugs_torch.ops.composite import composite_tiles_forward
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.rasterize_tiled import RasterConfig, tiles_to_image

__all__ = ["RasterConfig", "RenderOutput", "render"]

PRESORT_MAX_N = 1 << 18  # "auto"/"fastest" presort only up to this N
QKEY_BITS = 32  # requested qkey depth bits (capped in binning.expand_inputs)


@dataclasses.dataclass
class RenderOutput:
    color: torch.Tensor  # [H, W, 3]
    final_T: torch.Tensor  # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32
    radii: torch.Tensor  # [N] int32 (0 = culled)
    means2d: torch.Tensor  # [N, 2] screen positions
    depths: torch.Tensor  # [N]
    visible: torch.Tensor  # [N] bool
    num_pairs: torch.Tensor  # [] true pair count
    pair_overflow: torch.Tensor  # [] bool: pair capacity exceeded
    max_tile_hits: torch.Tensor  # [] busiest tile's pre-clamp entries
    hit_overflow: torch.Tensor  # [] bool: a tile exceeded max_hits_per_tile


def render(means, quats, log_scales, opacity_logits, sh, alive, viewmat,
           intrinsics, cfg: RasterConfig, sh_degree: int, background,
           scale_modifier: float = 1.0, presort="auto",
           need_grads: bool = True) -> RenderOutput:
    """Render one view. All tensors on one device; background [3].

    presort, as in the reference:
      "auto"         exact presort when N <= 2^18, else the 2-key sort;
      "exact"/True   always presort (stable argsort by depth);
      False          the 2-key (tile, depth) stable sort;
      "qkey"         one quantized (tile, depth bin) key, unstable: bounded
                     same-bin reorder, for display only;
      "fastest"      "exact" when N <= 2^18, else "qkey" (the viewer's).
    All but "qkey" render bit-identical images.

    need_grads: gradients through the compositor come with the training
    slice; until then True raises NotImplementedError, and with False the
    outputs carry no autograd graph."""
    if need_grads:
        raise NotImplementedError(
            "render(need_grads=True): gradients through the compositor come "
            "with the training slice (backward kernel + segment reduction); "
            "pass need_grads=False"
        )
    n = means.shape[0]
    if presort == "auto":
        presort = "exact" if n <= PRESORT_MAX_N else False
    elif presort == "fastest":
        presort = "exact" if n <= PRESORT_MAX_N else "qkey"
    if presort == "fast":
        raise NotImplementedError(
            "presort='fast' (quantized presort) is an off-path variant, not "
            "yet ported")
    quant_key_bits = 0
    if presort == "qkey":
        presort, quant_key_bits = False, QKEY_BITS
    with torch.no_grad():
        proj = project_gaussians(
            means, quats, log_scales, opacity_logits, sh, alive, viewmat,
            intrinsics, cfg.img_w, cfg.img_h, sh_degree, scale_modifier,
        )
        proj_b = B.presort_by_depth(proj)[1] if presort else proj
        binning = B.bin_gaussians_expand_kernel(
            proj_b, cfg.img_w, cfg.img_h, cfg.tile_w, cfg.tile_h,
            cfg.pair_capacity, presorted=bool(presort),
            quant_key_bits=quant_key_bits,
        )
        binning, max_tile_hits = B.clamp_tile_segments(
            binning, cfg.max_hits_per_tile)
        bg = torch.as_tensor(background, dtype=torch.float32,
                             device=means.device)
        color_t, t_t, nc_t = composite_tiles_forward(
            cfg, binning.tile_start, binning.tile_stop, binning.pair_gauss,
            proj_b.means2d, proj_b.conic, proj_b.rgb, proj_b.opac, bg,
        )
    h, w = cfg.img_h, cfg.img_w
    return RenderOutput(
        color=tiles_to_image(cfg, color_t)[:h, :w],
        final_T=tiles_to_image(cfg, t_t)[:h, :w],
        n_contrib=tiles_to_image(cfg, nc_t)[:h, :w],
        radii=proj.radii,
        means2d=proj.means2d,
        depths=proj.depths,
        visible=proj.visible,
        num_pairs=binning.num_pairs,
        pair_overflow=binning.overflow,
        max_tile_hits=max_tile_hits,
        hit_overflow=max_tile_hits > cfg.max_hits_per_tile,
    )

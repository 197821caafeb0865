"""Top-level render(): projection -> binning -> compositing, as in
tpugs/ops/render.py.

On the kernel route (the default) and a CUDA tensor every stage with a
kernel launches it (expand, align-copy, forward compositor; in the
backward the backward compositor and a segment sum); on a CPU tensor the
same stages run their plain PyTorch versions. compositor="scan" takes the
reference's scan branch instead: the whole-capacity binning and the scan
compositor with its analytic backward (ops/rasterize_tiled.py), an oracle
with no kernel. Projection, SH and the depth presort's permutation run
under autograd; binning carries no gradient.
"""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.ops import binning as B
from tpugs_torch.ops import composite as C
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.rasterize_tiled import (RasterConfig, composite_tiles,
                                             tiles_to_image)

__all__ = ["RasterConfig", "RenderOutput", "render", "render_state"]

PRESORT_MAX_N = 1 << 18  # "auto"/"fastest" presort only up to this N
QKEY_BITS = 32  # requested qkey depth bits (capped in binning.expand_inputs)
FAST_PRESORT_BITS = 12  # depth bits of presort="fast"'s key


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
           scale_modifier: float = 1.0, means2d_probe=None,
           compositor: str = "auto", presort="auto",
           need_grads: bool = True, carry_attrs: bool = False) -> RenderOutput:
    """Render one view. All tensors on one device; background [3].

    compositor:
      "auto"/"kernel"  the expand kernel's binning and the compositor
                       kernels (their plain versions on a CPU tensor).
                       The reference's "auto" takes the scan off the TPU;
                       the port's takes the kernel route on both devices.
      "scan"           the reference's scan branch: bin_gaussians (with
                       the presort) and the scan compositor with its
                       analytic backward. "qkey" sorts there by the exact
                       2-key sort; need_grads and carry_attrs are ignored.
                       An oracle for small frames: it reads the longest
                       segment to the host and loops in Python.

    presort, as in the reference:
      "auto"         exact presort when N <= 2^18, else the 2-key sort;
      "exact"/True   always presort (stable argsort by depth);
      "fast"         presort by one quantized key (12-bit depth bins,
                     ties by index; binning.presort_by_depth): same-bin
                     gaussians may composite out of depth order;
      False          the 2-key (tile, depth) stable sort;
      "qkey"         one quantized (tile, depth bin) key, unstable: bounded
                     same-bin reorder, for display only;
      "fastest"      "exact" when N <= 2^18, else "qkey" (the viewer's).
    All but "fast" and "qkey" render bit-identical images.

    means2d_probe: a zero [N, 2] tensor added to the screen positions; its
    gradient is dL/d(screen xy), which densification reads.

    need_grads: True (the default) differentiates through the compositor
    with the backward kernel and a segment sum: the sorted one, or the
    classic one over binning's reduce_meta where
    composite.segred_needs_meta says so (n >= 2^24, or
    composite.SORTED_SEGRED_MIN raised). False, as in the reference, builds
    no reduce_meta and still differentiates, through the scatter-add
    gradient (composite.CompositeScatter, at most 2^24 gaussians), when
    autograd is on and an input requires a gradient; otherwise it builds no
    graph at all.

    carry_attrs: the expand kernel's carry mode streams the nine compositor
    attributes per pair and the sort carries them, in place of the gather
    that packs them per sorted pair; images and gradients are bit-identical
    either way."""
    if compositor not in ("auto", "kernel", "scan"):
        raise ValueError(f"unknown compositor {compositor!r}")
    n = means.shape[0]
    if presort == "auto":
        presort = "exact" if n <= PRESORT_MAX_N else False
    elif presort == "fastest":
        presort = "exact" if n <= PRESORT_MAX_N else "qkey"
    quant_key_bits = 0
    if presort == "qkey":
        presort, quant_key_bits = False, QKEY_BITS
    bg = torch.as_tensor(background, dtype=torch.float32, device=means.device)
    inputs = (means, quats, log_scales, opacity_logits, sh, means2d_probe, bg)
    graph = torch.is_grad_enabled() and (need_grads or any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in inputs))
    reduce_meta = need_grads and C.segred_needs_meta(cfg, n)
    with torch.set_grad_enabled(graph):
        proj = project_gaussians(
            means, quats, log_scales, opacity_logits, sh, alive, viewmat,
            intrinsics, cfg.img_w, cfg.img_h, sh_degree, scale_modifier,
        )
        if presort:
            # The probe rides inside the permuted table, so its gradient
            # comes back to the original order through the gather.
            proj_b = proj
            if means2d_probe is not None:
                proj_b = dataclasses.replace(
                    proj, means2d=proj.means2d + means2d_probe)
            quant = FAST_PRESORT_BITS if presort == "fast" else 0
            proj_b = B.presort_by_depth(proj_b, quant_bits=quant)[1]
            means2d = proj_b.means2d
        else:
            proj_b = proj
            means2d = proj.means2d
            if means2d_probe is not None:
                means2d = means2d + means2d_probe
        with torch.no_grad():
            if compositor == "scan":
                binning = B.bin_gaussians(
                    proj_b, cfg.img_w, cfg.img_h, cfg.tile_w, cfg.tile_h,
                    cfg.pair_capacity, presorted=bool(presort))
            else:
                binning = B.bin_gaussians_expand_kernel(
                    proj_b, cfg.img_w, cfg.img_h, cfg.tile_w, cfg.tile_h,
                    cfg.pair_capacity, presorted=bool(presort),
                    quant_key_bits=quant_key_bits, reduce_meta=reduce_meta,
                    carry_attrs=carry_attrs,
                )
            binning, max_tile_hits = B.clamp_tile_segments(
                binning, cfg.max_hits_per_tile)
        b = binning
        args = (cfg, b.tile_start, b.tile_stop, b.pair_gauss, means2d,
                proj_b.conic, proj_b.rgb, proj_b.opac, bg, 0)
        if compositor == "scan":
            color_t, t_t, nc_t = composite_tiles(*args)
        elif need_grads:
            meta = ((b.pair_tile, b.exp_slot, b.red_start, b.red_count,
                     b.exp_end) if reduce_meta else None)
            color_t, t_t, nc_t = C.CompositeSegred.apply(*args, meta, b.attr_c)
        elif graph:
            color_t, t_t, nc_t = C.CompositeScatter.apply(*args, b.attr_c)
        else:
            color_t, t_t, nc_t = C.composite_tiles_forward(*args, b.attr_c)
    h, w = cfg.img_h, cfg.img_w
    color = tiles_to_image(cfg, color_t)[:h, :w]
    final_t = tiles_to_image(cfg, t_t)[:h, :w]
    return RenderOutput(
        color=color,
        final_T=final_t,
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


def render_state(state, viewmat, intrinsics, cfg: RasterConfig,
                 sh_degree: int, background, **kw) -> RenderOutput:
    """render() of a GaussianState (its five parameter arrays and alive);
    kw as render()'s."""
    return render(state.means, state.quats, state.log_scales,
                  state.opacity_logits, state.sh, state.alive, viewmat,
                  intrinsics, cfg, sh_degree, background, **kw)

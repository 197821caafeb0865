"""Frame-coherent cached rendering, the interactive viewer's drag path, as
in tpugs/ops/render_cached.py.

A frame splits in two:

  build_frame_cache(...)   the exact binning at an ANCHOR camera (the
                           expand kernel, the qkey sort, the align-copy
                           kernel) and one gather of the camera-independent
                           per-pair quantities (world mean, cov3d
                           components, opacity, the anchor's SH colour)
                           into the compositor's aligned layout;
  render_cached(cache, viewmat, ...)
                           one frame at a nearby camera: every aligned slot
                           re-projected exactly for the new camera in plain
                           elementwise PyTorch (world to camera, the
                           perspective divide, EWA to the conic), then the
                           forward compositor kernel. No binning, no sort,
                           no gather, and no host read.

Approximation (display only): tile membership and compositing order are
the anchor camera's, and the colour is the anchor's SH evaluation, while
positions and footprints are exact for the new camera. So a gaussian whose
footprint entered a tile since the anchor is missing there, and near-equal
depths may blend in the anchor's order; the error grows with the camera's
move from the anchor, and the viewer re-anchors past a threshold
(viewer/offline.py). At zero camera delta the frame is bit-identical to
render(presort="qkey", need_grads=False).
"""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.core import transforms as tf
from tpugs_torch.ops import binning as B
from tpugs_torch.ops import composite_t, pack
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.rasterize_tiled import RasterConfig, tiles_to_image

# Rows of FrameCache.static_attr ([pack.ATTR_ROWS, P_aligned], gap columns
# zero):
#   0-2   world mean x y z
#   3-8   cov3d components c00 c01 c02 c11 c12 c22
#   9     activated opacity (0 for dead slots)
#   10-12 the anchor's SH colour (clamped >= 0)
#   13    validity (1 a pair, 0 an alignment gap)
_VALID = 13


@dataclasses.dataclass
class FrameCache:
    """The anchor frame's binning and camera-independent per-pair table."""

    astart: torch.Tensor  # [T] int32 aligned segment starts
    astop: torch.Tensor  # [T] int32 aligned segment stops
    static_attr: torch.Tensor  # [ATTR_ROWS, P_aligned] f32
    anchor_viewmat: torch.Tensor  # [4, 4]
    num_pairs: torch.Tensor  # [] true pair count, as RenderOutput's
    pair_overflow: torch.Tensor  # [] bool
    max_tile_hits: torch.Tensor  # [] busiest tile before the clamp


def build_frame_cache(means, quats, log_scales, opacity_logits, sh, alive,
                      viewmat, intrinsics, cfg: RasterConfig, sh_degree: int,
                      scale_modifier: float = 1.0) -> FrameCache:
    """The exact binning at the anchor camera and the static per-pair
    gather. The viewer's binning: the expand kernel, the quantized pair
    key, no reduce metadata. The table's columns are
    pack.p_aligned_chunked's static count, so sizing it reads nothing from
    the device; the expansion's pair count is the one host read."""
    with torch.no_grad():
        proj = project_gaussians(
            means, quats, log_scales, opacity_logits, sh, alive, viewmat,
            intrinsics, cfg.img_w, cfg.img_h, sh_degree, scale_modifier)
        binning = B.bin_gaussians_expand_kernel(
            proj, cfg.img_w, cfg.img_h, cfg.tile_w, cfg.tile_h,
            cfg.pair_capacity, presorted=False, reduce_meta=False,
            carry_attrs=False, quant_key_bits=32)
        binning, max_tile_hits = B.clamp_tile_segments(
            binning, cfg.max_hits_per_tile)
        astart, astop, counts = pack.aligned_offsets(binning.tile_start,
                                                     binning.tile_stop)
        p_aligned = pack.p_aligned_chunked(cfg.pair_capacity, cfg.num_tiles)

        comps = tf.cov3d_components(log_scales, quats, scale_modifier)
        opac = torch.where(alive, torch.sigmoid(opacity_logits),
                           torch.zeros_like(opacity_logits))
        stat = torch.cat([means, comps, opac[:, None], proj.rgb], dim=1)
        # Valid pairs occupy the first min(num_pairs, capacity) sorted
        # slots, as in render()'s pack.
        pg = binning.pair_gauss[: min(binning.pair_gauss.shape[0],
                                      cfg.pair_capacity)]
        rows = stat[pg.to(torch.int64)]  # [P, 13]: the one row gather
        pc_pad = pg.shape[0] + pack.CHUNK + 2 * pack.LANE_ALIGN
        attr_cp = torch.zeros((pack.ATTR_ROWS, pc_pad), dtype=torch.float32,
                              device=means.device)
        attr_cp[: rows.shape[1], : rows.shape[0]] = rows.T
        attr_cp[_VALID, : rows.shape[0]] = 1.0
        static_attr = pack.align_copy(attr_cp, binning.tile_start, astart,
                                      counts, p_aligned)
    return FrameCache(astart=astart, astop=astop, static_attr=static_attr,
                      anchor_viewmat=viewmat, num_pairs=binning.num_pairs,
                      pair_overflow=binning.overflow,
                      max_tile_hits=max_tile_hits)


def render_cached(cache: FrameCache, viewmat, intrinsics, cfg: RasterConfig,
                  background):
    """One cached frame: each aligned slot re-projected exactly for
    `viewmat`, composited in the anchor's tile order -> (color [H, W, 3],
    final_T [H, W]).

    The same screen-space math as project_gaussians and
    pack.gaussian_attrs, per slot of the static table. The forward
    compositor reads only inside [astart, astop), so the slots past the last
    segment, which the align-copy kernel leaves unwritten, are re-projected
    and never read; nothing here reduces over the table."""
    with torch.no_grad():
        fx, fy, cx, cy = (intrinsics[0], intrinsics[1], intrinsics[2],
                          intrinsics[3])
        W = viewmat[:3, :3]
        s = cache.static_attr
        means3 = torch.stack([s[0], s[1], s[2]], dim=-1)  # [P_al, 3]
        comps = torch.stack([s[3], s[4], s[5], s[6], s[7], s[8]], dim=-1)

        t_cam = tf.world_to_camera_points(means3, viewmat)
        tz = t_cam[..., 2]
        in_front = tz > tf.NEAR_PLANE
        safe_z = torch.where(in_front, tz, torch.ones_like(tz))
        x_screen = fx * t_cam[..., 0] / safe_z + cx
        y_screen = fy * t_cam[..., 1] / safe_z + cy

        t_guard = torch.where(in_front[..., None], t_cam,
                              torch.ones_like(t_cam))
        cov2d = tf.ewa_cov2d_from_comps(comps, W, t_guard, fx, fy)
        conic, det = tf.inv_cov2d(cov2d)
        # A pair culled at the new camera (behind the near plane, or a
        # degenerate footprint) contributes nothing, as binning culls it on
        # the exact path.
        opac_eff = torch.where(in_front & (det > 0.0), s[9],
                               torch.zeros_like(s[9]))
        zero = torch.zeros_like(tz)
        rows = [x_screen, y_screen, -0.5 * conic[..., 0], -conic[..., 1],
                -0.5 * conic[..., 2], opac_eff, s[10], s[11], s[12],
                zero,  # pack.GID_ROW: read by the backward only
                s[_VALID]]  # pack.VALID_ROW
        rows += [zero] * (pack.ATTR_ROWS - len(rows))
        attr = torch.stack(rows)

        color_t, t_t, _, _ = composite_t.composite_forward(
            cfg, cache.astart, cache.astop, attr, 0)
        bg = torch.as_tensor(background, dtype=torch.float32,
                             device=color_t.device)
        color_t = color_t + t_t[..., None] * bg[None, None, :]
        h, w = cfg.img_h, cfg.img_w
        color = tiles_to_image(cfg, color_t)[:h, :w]
        final_t = tiles_to_image(cfg, t_t)[:h, :w]
    return color, final_t

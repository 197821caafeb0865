"""tpugs_torch's forward compositor (the kernel's plain version) against
tpugs' Pallas forward kernel in interpret mode, and the port's scan-
compositor oracle against tpugs' scan compositor. Color and T within 1e-5
(the reference kernel's prefix-product tree drifts at ulp scale), n_contrib
and k_last equal on >= 99.9% of pixels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_projection, np_, random_projection, torch_projection
from tpugs.ops import rasterize_tiled as JR
from tpugs.ops.pallas.composite_t import composite_forward_pallas
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite_t as TC
from tpugs_torch.ops import pack as TP
from tpugs_torch.ops import rasterize_tiled as TR
from tpugs_torch.ops.composite import composite_tiles_forward

torch.set_num_threads(1)

ATOL = 1e-5
MIN_MATCH = 0.999
CAP = 8192


def _scene(w, h, tile, seed, max_hits=512):
    """Binned, packed and aligned pairs of a random screen-space scene."""
    d = random_projection(300, w, h, seed, big_rects=True)
    d["opac"] = np.random.default_rng(seed).uniform(0.3, 0.99, 300).astype(np.float32)
    tp = torch_projection(d)
    cfg = TR.RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                          pair_capacity=CAP, max_hits_per_tile=max_hits)
    b, _ = TB.clamp_tile_segments(
        TB.bin_gaussians_expand_kernel(tp, w, h, tile, tile, CAP), max_hits)
    astart, astop, counts = TP.aligned_offsets(b.tile_start, b.tile_stop)
    attr_c = TP.pack_compact_attrs(b.pair_gauss, tp.means2d, tp.conic, tp.rgb,
                                   tp.opac, b.pair_gauss.shape[0])
    attr = TP.align_copy(attr_c, b.tile_start, astart, counts,
                         TP.aligned_length(astart, counts))
    return d, tp, cfg, b, astart, astop, attr


def _assert_close(got, ref):
    (c, t, nc, kl), (c0, t0, nc0, kl0) = [[np_(x) for x in o] for o in (got, ref)]
    np.testing.assert_allclose(c, c0, atol=ATOL)
    np.testing.assert_allclose(t, t0, atol=ATOL)
    assert (nc == nc0).mean() >= MIN_MATCH
    assert (kl == kl0).mean() >= MIN_MATCH


@pytest.mark.parametrize("w,h,tile,seed", [(64, 48, 16, 0), (96, 64, 32, 1),
                                           (96, 64, 16, 2)])
def test_forward_matches_pallas_kernel(w, h, tile, seed):
    _, _, cfg, _, astart, astop, attr = _scene(w, h, tile, seed)
    got = TC.composite_forward(cfg, astart, astop, attr)
    # The reference kernel reads CHUNK-wide windows past a segment: pad.
    attr_j = jnp.asarray(np.pad(np_(attr), ((0, 0), (0, 1024))))
    jcfg = JR.RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=CAP, max_hits_per_tile=512)
    ref = composite_forward_pallas(jcfg, jnp.asarray(np_(astart)),
                                   jnp.asarray(np_(astop)), attr_j,
                                   interpret=True)
    _assert_close(got, ref)
    assert np_(got[2]).max() > 3  # pixels with several contributors
    assert (np_(got[1]) < TR.T_THRESHOLD).any()  # and saturated pixels


def test_forward_tile_subset_matches_full():
    _, _, cfg, _, astart, astop, attr = _scene(96, 64, 16, 3)
    full = TC.composite_forward_plain(cfg, astart, astop, attr)
    sel = torch.tensor([5, 0, 23, 11])
    sub = TC.composite_forward_plain(cfg, astart, astop, attr, tiles=sel)
    for a, b in zip(full, sub):
        np.testing.assert_array_equal(np_(a)[np_(sel)], np_(b))


@pytest.mark.parametrize("w,h,tile,max_hits", [(64, 48, 16, 512), (96, 64, 32, 6)])
def test_scan_oracles_agree(w, h, tile, max_hits):
    """The port's scan compositor against tpugs' scan compositor on the same
    binned pairs, and the kernel path (composite_tiles_forward) against the
    port's scan compositor; max_hits 6 truncates the busy tiles."""
    d, tp, cfg, b, *_ = _scene(w, h, tile, 4, max_hits)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    args = (b.tile_start, b.tile_stop, b.pair_gauss)
    got = TR.composite_tiles_scan(cfg, *args, tp.means2d, tp.conic, tp.rgb,
                                  tp.opac, torch.from_numpy(bg))
    jcfg = JR.RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=CAP, max_hits_per_tile=max_hits)
    jp = jax_projection(d)
    ref = JR._composite_fwd_impl(jcfg, *(jnp.asarray(np_(a)) for a in args),
                                 jp.means2d, jp.conic, jp.rgb, jp.opac,
                                 jnp.asarray(bg))
    _assert_close(got, ref)
    kern = composite_tiles_forward(cfg, *args, tp.means2d, tp.conic, tp.rgb,
                                   tp.opac, torch.from_numpy(bg))
    for a, b_ in zip(kern, got[:3]):
        np.testing.assert_allclose(np_(a), np_(b_), atol=ATOL)


def test_tile_image_round_trip():
    cfg = TR.RasterConfig(img_h=40, img_w=72, tile_h=16, tile_w=32)
    img = torch.arange(cfg.padded_h * cfg.padded_w * 3, dtype=torch.float32)
    img = img.reshape(cfg.padded_h, cfg.padded_w, 3)
    tiled = TR.image_to_tiles(cfg, img)
    ref = JR.image_to_tiles(JR.RasterConfig(img_h=40, img_w=72, tile_h=16,
                                            tile_w=32), jnp.asarray(np_(img)))
    np.testing.assert_array_equal(np_(tiled), np.asarray(ref))
    np.testing.assert_array_equal(np_(TR.tiles_to_image(cfg, tiled)), np_(img))
    px, py = TR._pixel_coords(cfg, "cpu")
    jpx, jpy = JR._pixel_coords(JR.RasterConfig(img_h=40, img_w=72, tile_h=16,
                                                tile_w=32))
    np.testing.assert_array_equal(np_(px), np.asarray(jpx))
    np.testing.assert_array_equal(np_(py), np.asarray(jpy))

"""The pre-aligned path of tpugs_torch against tpugs: bin_gaussians_aligned,
align_segments, p_aligned and CompositePre (tpugs'
composite_tiles_pallas_pre, its Pallas kernels in interpret mode).

Tolerances: the aligned layout (pair_gauss, pair_valid, tile_start,
tile_stop, num_pairs, overflow) bit-equal to tpugs' and to the port's own
align_segments(bin_gaussians(...)); CompositePre's colour and final_T
atol 1e-5 and its gradients rtol 1e-4, atol 2e-5 max|g| against tpugs and
against the scan compositor (tests/test_binning_aligned.py's rtol; the
summation order of the scatter-adds differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (assert_grads_close, jax_projection, np_,
                                random_projection, torch_projection)
from tpugs.ops import binning as JB
from tpugs.ops.pallas import composite as JC
from tpugs.ops.rasterize_tiled import RasterConfig as JaxConfig
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite as TC
from tpugs_torch.ops import composite_t
from tpugs_torch.ops import pack as TP
from tpugs_torch.ops import rasterize_tiled as TT

torch.set_num_threads(1)

ATOL = 1e-5
CAP = 8192
SHAPES = [(64, 48, 16), (96, 64, 32)]
FIELDS = ("pair_gauss", "pair_valid", "tile_start", "tile_stop", "num_pairs",
          "overflow")
ATTRS = ("means2d", "conic", "rgb", "opac")
BG = np.float32([0.1, 0.2, 0.3])


def _cfgs(w, h, tile, cap=CAP):
    kw = dict(img_h=h, img_w=w, tile_h=tile, tile_w=tile, pair_capacity=cap,
              max_hits_per_tile=256)
    return JaxConfig(**kw), TT.RasterConfig(**kw)


def _assert_layout_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np_(getattr(a, f)), np_(getattr(b, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cap", [CAP, 2_453_504])
def test_p_aligned_is_the_reference_capacity(cap):
    for w, h, tile in SHAPES + [(1297, 840, 32)]:
        jcfg, cfg = _cfgs(w, h, tile, cap=cap)
        assert TC.p_aligned(cfg) == JC._p_aligned(jcfg)
        # 128 pad per tile, not pack.p_aligned_chunked's 127.
        assert TC.p_aligned(cfg) >= TP.p_aligned_chunked(cfg.pair_capacity,
                                                         cfg.num_tiles)


@pytest.mark.parametrize("w,h,tile", SHAPES)
@pytest.mark.parametrize("seed,big", [(0, False), (3, True)])
def test_aligned_binning_bit_equal(w, h, tile, seed, big):
    d = random_projection(300, w, h, seed, big_rects=big)
    jp, tp = jax_projection(d), torch_projection(d)
    jcfg, cfg = _cfgs(w, h, tile)
    pal = TC.p_aligned(cfg)
    got = TB.bin_gaussians_aligned(tp, w, h, tile, tile, CAP, pal)
    ref = JB.bin_gaussians_aligned(jp, w, h, tile, tile, CAP, pal)
    _assert_layout_equal(got, ref)
    assert not bool(got.overflow) and int(got.num_pairs) > 0
    # The oracle layout, from the port's compact binning.
    b = TB.bin_gaussians(tp, w, h, tile, tile, CAP)
    astart, astop, agauss, avalid = TC.align_segments(
        b.tile_start, b.tile_stop, b.pair_gauss, pal)
    assert torch.equal(got.tile_start, astart)
    assert torch.equal(got.tile_stop, astop)
    assert torch.equal(got.pair_valid, avalid)
    assert torch.equal(got.pair_gauss, agauss)


@pytest.mark.parametrize("w,h,tile", SHAPES)
def test_align_segments_matches_jax(w, h, tile):
    d = random_projection(300, w, h, 1)
    jp, tp = jax_projection(d), torch_projection(d)
    pal = TC.p_aligned(_cfgs(w, h, tile)[1])
    jb = JB.bin_gaussians(jp, w, h, tile, tile, CAP)
    tb = TB.bin_gaussians(tp, w, h, tile, tile, CAP)
    ref = JC.align_segments(jb.tile_start, jb.tile_stop, jb.pair_gauss, pal)
    got = TC.align_segments(tb.tile_start, tb.tile_stop, tb.pair_gauss, pal)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


@pytest.mark.parametrize("p_aligned", [256, 1024])
def test_aligned_overflow_flag(p_aligned):
    """Past the aligned capacity the flag is set and the pairs past it are
    dropped, as tpugs' (which scatters with mode="drop")."""
    w, h, tile = 64, 48, 16
    d = random_projection(300, w, h, 2)
    jp, tp = jax_projection(d), torch_projection(d)
    got = TB.bin_gaussians_aligned(tp, w, h, tile, tile, CAP, p_aligned)
    ref = JB.bin_gaussians_aligned(jp, w, h, tile, tile, CAP, p_aligned)
    _assert_layout_equal(got, ref)
    assert bool(got.overflow)
    assert got.pair_gauss.shape == (p_aligned,)


@pytest.mark.parametrize("rows", [(1, 1), (2, 2)])
def test_aligned_binning_row_slice(rows):
    lo, num = rows
    w, h, tile = 96, 64, 16
    d = random_projection(300, w, h, 4)
    jp, tp = jax_projection(d), torch_projection(d)
    got = TB.bin_gaussians_aligned(tp, w, h, tile, tile, CAP, 4096,
                                   tile_row_lo=lo, num_tile_rows=num)
    ref = JB.bin_gaussians_aligned(jp, w, h, tile, tile, CAP, 4096,
                                   tile_row_lo=lo, num_tile_rows=num)
    _assert_layout_equal(got, ref)
    assert got.tile_start.shape == (num * (-(-w // tile)),)
    assert int(got.pair_valid.sum()) > 0


def _pre_grads(d, c_col, c_t, fn):
    """fn's (colour, final_T, n_contrib) and gradients of a seeded
    cotangent in the projected attributes and the background."""
    tp = torch_projection(d)
    ins = [getattr(tp, k).clone().requires_grad_(True) for k in ATTRS]
    bg = torch.from_numpy(BG).requires_grad_(True)
    out = fn(*ins, bg)
    loss = ((out[0] * torch.from_numpy(c_col)).sum()
            + (out[1] * torch.from_numpy(c_t)).sum())
    grads = torch.autograd.grad(loss, ins + [bg])
    return [np_(x) for x in out], dict(zip(ATTRS + ("bg",), map(np_, grads)))


@pytest.mark.parametrize("w,h,tile,seed", [(64, 48, 16, 1), (96, 64, 32, 2)])
def test_composite_pre_matches_jax_and_scan(w, h, tile, seed):
    d = random_projection(200, w, h, seed)
    d["opac"][:30] = 0.999  # the 0.99 clamp and saturated pixels
    jp, tp = jax_projection(d), torch_projection(d)
    jcfg, cfg = _cfgs(w, h, tile)
    pal = TC.p_aligned(cfg)
    rng = np.random.default_rng(seed + 10)
    c_col = rng.normal(size=(cfg.num_tiles, cfg.pix, 3)).astype(np.float32)
    c_t = rng.normal(size=(cfg.num_tiles, cfg.pix)).astype(np.float32)

    ja = JB.bin_gaussians_aligned(jp, w, h, tile, tile, CAP, pal)

    def jloss(m, c, r, o, bg):
        out = JC.composite_tiles_pallas_pre(
            jcfg, ja.tile_start, ja.tile_stop, ja.pair_gauss, ja.pair_valid,
            m, c, r, o, bg)
        return jnp.sum(out[0] * c_col) + jnp.sum(out[1] * c_t), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True)(
        jp.means2d, jp.conic, jp.rgb, jp.opac, jnp.asarray(BG))
    jg = dict(zip(ATTRS + ("bg",), map(np.asarray, jg)))

    a = TB.bin_gaussians_aligned(tp, w, h, tile, tile, CAP, pal)
    pre, pg = _pre_grads(d, c_col, c_t, lambda *x: TC.CompositePre.apply(
        cfg, a.tile_start, a.tile_stop, a.pair_gauss, a.pair_valid, *x))
    b = TB.bin_gaussians(tp, w, h, tile, tile, CAP)
    scan, sg = _pre_grads(d, c_col, c_t, lambda *x: TT.composite_tiles(
        cfg, b.tile_start, b.tile_stop, b.pair_gauss, *x))
    for i in range(2):
        np.testing.assert_allclose(pre[i], np.asarray(ref[i]), atol=ATOL)
        np.testing.assert_allclose(pre[i], scan[i], atol=ATOL)
    np.testing.assert_array_equal(pre[2], np.asarray(ref[2]))
    np.testing.assert_array_equal(pre[2], scan[2])
    assert_grads_close(pg, jg)
    assert_grads_close(pg, sg)
    invisible = ~d["visible"]
    for k in ATTRS:
        assert not np.any(pg[k][invisible]), k


def test_composite_pre_masks_unwritten_slots(monkeypatch):
    """The backward kernel leaves slots outside the walked entries
    unwritten (here NaN): CompositePre selects them away, never multiplies,
    so its gradients are those of the zeroed rows."""
    w, h, tile = 64, 48, 16
    d = random_projection(200, w, h, 6)
    cfg = _cfgs(w, h, tile)[1]
    pal = TC.p_aligned(cfg)
    tp = torch_projection(d)
    a = TB.bin_gaussians_aligned(tp, w, h, tile, tile, CAP, pal)
    rng = np.random.default_rng(7)
    c_col = rng.normal(size=(cfg.num_tiles, cfg.pix, 3)).astype(np.float32)
    c_t = rng.normal(size=(cfg.num_tiles, cfg.pix)).astype(np.float32)

    def run():
        return _pre_grads(d, c_col, c_t,
                          lambda *x: TC.CompositePre.apply(
                              cfg, a.tile_start, a.tile_stop, a.pair_gauss,
                              a.pair_valid, *x))[1]

    clean = run()
    plain = composite_t.composite_backward

    def poisoned(*args, **kw):
        out = plain(*args, **kw)
        walked = torch.zeros(out.shape[0], dtype=torch.bool)
        for s, e in zip(a.tile_start.tolist(), a.tile_stop.tolist()):
            walked[s:e] = True
        out[~walked] = float("nan")
        return out

    monkeypatch.setattr(composite_t, "composite_backward", poisoned)
    dirty = run()
    assert int((~a.pair_valid).sum()) > 0
    for k in clean:
        np.testing.assert_array_equal(dirty[k], clean[k], err_msg=k)

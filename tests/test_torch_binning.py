"""tpugs_torch binning (expand kernel's plain version + torch.sort) against
tpugs' binning with its Pallas expand kernel in interpret mode: the sorted
per-tile segments are bit-identical for the presorted and 2-key sorts,
overflow truncation included; the qkey sort holds the same key sequence
and the same gids per tile."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_carry import _by_pair
from tests.torch_parity import (PROJ_FIELDS, assert_segments_equal,
                                jax_projection, np_, random_projection,
                                segments, torch_projection)
from tpugs.ops import binning as JB
from tpugs.ops.pallas import expand as JEX
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import expand as TEX
from tpugs_torch.ops import pack as TP

torch.set_num_threads(1)

SHAPES = [(64, 48, 16), (96, 64, 32)]
CAP = 8192


def _inputs(w, h, seed, **kw):
    d = random_projection(300, w, h, seed, **kw)
    return jax_projection(d), torch_projection(d)


def _num_tiles(w, h, tile):
    return (-(-w // tile)) * (-(-h // tile))


@pytest.mark.parametrize("w,h,tile", SHAPES)
def test_rects_and_cull_radius(w, h, tile):
    jp, tp = _inputs(w, h, 0)
    r2_j, r2_t = JB.cull_radius_sq(jp), TB.cull_radius_sq(tp)
    # log() is XLA's polynomial on one side and torch's on the other: they
    # differ by an ulp on a few inputs.
    np.testing.assert_allclose(np_(r2_t), np_(r2_j), rtol=3e-7)
    for a, b in zip(TB.tile_rects(tp, w, h, tile, tile, r2_t),
                    JB.tile_rects(jp, w, h, tile, tile, r2_j)):
        np.testing.assert_array_equal(np_(a)[np_(tp.visible)],
                                      np_(b)[np_(tp.visible)])


@pytest.mark.parametrize("w,h,tile", SHAPES)
@pytest.mark.parametrize("seed,cap,big", [(0, CAP, False), (3, CAP, True),
                                          (5, None, True)])
def test_two_key_sort_bit_identical(w, h, tile, seed, cap, big):
    """The 2-key (tile, depth, gid) path; cap None = half the pairs, so the
    back half is dropped (overflow)."""
    jp, tp = _inputs(w, h, seed, big_rects=big)
    total = int(TB.expand_inputs(tp, w, h, tile, tile, CAP).total)
    overflow = cap is None
    cap = total // 2 if overflow else cap
    ref = JB.bin_gaussians_expand_kernel(jp, w, h, tile, tile, cap,
                                         interpret=True)
    got = TB.bin_gaussians_expand_kernel(tp, w, h, tile, tile, cap)
    nt = _num_tiles(w, h, tile)
    assert_segments_equal(ref, got, nt)
    assert bool(got.overflow) == overflow
    # The oracle of both packages agrees too.
    assert_segments_equal(JB.bin_gaussians(jp, w, h, tile, tile, cap),
                          TB.bin_gaussians(tp, w, h, tile, tile, cap), nt)
    assert_segments_equal(got, TB.bin_gaussians(tp, w, h, tile, tile, cap), nt)


@pytest.mark.parametrize("w,h,tile", SHAPES)
@pytest.mark.parametrize("overflow", [False, True])
def test_presorted_bit_identical(w, h, tile, overflow):
    jp, tp = _inputs(w, h, 1, big_rects=True)
    total = int(TB.expand_inputs(tp, w, h, tile, tile, CAP).total)
    cap = total // 2 if overflow else CAP
    perm_j, jps = JB.presort_by_depth(jp)
    perm_t, tps = TB.presort_by_depth(tp)
    np.testing.assert_array_equal(np_(perm_t), np_(perm_j))
    ref = JB.bin_gaussians_expand_kernel(jps, w, h, tile, tile, cap,
                                         interpret=True, presorted=True)
    got = TB.bin_gaussians_expand_kernel(tps, w, h, tile, tile, cap,
                                         presorted=True)
    nt = _num_tiles(w, h, tile)
    assert_segments_equal(ref, got, nt)
    assert bool(got.overflow) == overflow
    assert_segments_equal(
        JB.bin_gaussians(jps, w, h, tile, tile, cap, presorted=True),
        TB.bin_gaussians(tps, w, h, tile, tile, cap, presorted=True), nt)


FAST_BITS = 12  # render(presort="fast")'s


def _fast_bins(jp, n):
    """The reference's depth bins of presort_by_depth(quant_bits=12), as
    float32 before the cast (tpugs/ops/binning.py's formula)."""
    bits = min(FAST_BITS, 32 - max(1, (n - 1).bit_length()))
    nbins = (1 << bits) - 1
    d, vis = jp.depths, jp.visible
    dmin = jnp.min(jnp.where(vis, d, jnp.inf))
    dmax = jnp.max(jnp.where(vis, d, -jnp.inf))
    scale = (nbins - 1) / jnp.maximum(dmax - dmin, 1e-12)
    return np.asarray(jnp.clip((d - dmin) * scale, 0, nbins - 1)), nbins


@pytest.mark.parametrize("w,h,tile", SHAPES)
@pytest.mark.parametrize("seed,ties", [(0, True), (5, False)])
def test_fast_presort_matches_jax(w, h, tile, seed, ties):
    """presort_by_depth(quant_bits=12): the permutation and the permuted
    projection equal tpugs'; inside a bin by index; invisible last; the
    presorted binning of it bit-identical to tpugs' too."""
    jp, tp = _inputs(w, h, seed, ties=ties)
    perm_j, jps = JB.presort_by_depth(jp, quant_bits=FAST_BITS)
    perm_t, tps = TB.presort_by_depth(tp, quant_bits=FAST_BITS)
    perm = np_(perm_t)
    np.testing.assert_array_equal(perm, np_(perm_j))
    for f in PROJ_FIELDS:
        np.testing.assert_array_equal(np_(getattr(tps, f)),
                                      np_(getattr(jps, f)), err_msg=f)
    vis = np_(tp.visible)[perm]
    nvis = int(vis.sum())
    assert vis[:nvis].all() and not vis[nvis:].any()
    bins = _fast_bins(jp, perm.shape[0])[0].astype(np.int64)[perm[:nvis]]
    assert np.all(np.diff(bins) >= 0)
    same = np.diff(bins) == 0
    assert same.any() and np.all(np.diff(perm[:nvis])[same] > 0)
    ref = JB.bin_gaussians_expand_kernel(jps, w, h, tile, tile, CAP,
                                         interpret=True, presorted=True)
    got = TB.bin_gaussians_expand_kernel(tps, w, h, tile, tile, CAP,
                                         presorted=True)
    assert_segments_equal(ref, got, _num_tiles(w, h, tile))


def test_fast_presort_distinct_bins_equal_exact():
    """Where every distinct visible depth has a bin of its own, the fast
    presort is the exact one, bit for bit (ties break by index in both)."""
    d = random_projection(300, 96, 64, 0, ties=False)
    levels = 64
    d["depths"] = (np.round((d["depths"] - 0.5) / 19.5 * (levels - 1))
                   / (levels - 1) * 19.5 + 0.5).astype(np.float32)
    jp, tp = jax_projection(d), torch_projection(d)
    # Precondition: distinct depths lie at least 2 bins apart and no
    # interior depth within 1e-3 of a bin edge, so no ulp decides a bin.
    x, nbins = _fast_bins(jp, 300)
    xv = np.unique(x[d["visible"]].astype(np.float64))
    assert np.diff(xv).min() >= 2.0
    inner = xv[(xv > 0) & (xv < nbins - 1)]
    assert np.abs(inner - np.round(inner)).min() > 1e-3
    perm_e, pe = TB.presort_by_depth(tp)
    perm_f, pf = TB.presort_by_depth(tp, quant_bits=FAST_BITS)
    assert torch.equal(perm_e, perm_f)
    for f in PROJ_FIELDS:
        assert torch.equal(getattr(pe, f), getattr(pf, f)), f


def test_fast_presort_edges_match_jax(monkeypatch):
    """No visible gaussian: every key in the sentinel bin, the index order.
    An index past 31 bits: the exact sort (forced here through the
    index-bit count)."""
    d = random_projection(200, 64, 48, 3)
    d["visible"][:] = False
    jp, tp = jax_projection(d), torch_projection(d)
    perm_t = np_(TB.presort_by_depth(tp, quant_bits=FAST_BITS)[0])
    np.testing.assert_array_equal(
        perm_t, np_(JB.presort_by_depth(jp, quant_bits=FAST_BITS)[0]))
    np.testing.assert_array_equal(perm_t, np.arange(200))
    d = random_projection(200, 64, 48, 3)
    tp = torch_projection(d)
    exact = TB.presort_by_depth(tp)[0]
    monkeypatch.setattr(TB, "_index_bits", lambda n: 32)
    assert torch.equal(TB.presort_by_depth(tp, quant_bits=FAST_BITS)[0], exact)


def _qbins(proj, w, h, tile):
    ex = TB.expand_inputs(proj, w, h, tile, tile, CAP, quant_key_bits=32)
    return np_(ex.ftab[3]), ex.qbits


@pytest.mark.parametrize("w,h,tile", SHAPES)
def test_qkey_same_keys_and_gids_per_tile(w, h, tile):
    jp, tp = _inputs(w, h, 2, big_rects=True, ties=True)
    ref = JB.bin_gaussians_expand_kernel(jp, w, h, tile, tile, CAP,
                                         interpret=True, quant_key_bits=32)
    got = TB.bin_gaussians_expand_kernel(tp, w, h, tile, tile, CAP,
                                         quant_key_bits=32)
    bins, qbits = _qbins(tp, w, h, tile)
    nt = _num_tiles(w, h, tile)
    assert qbits == min(22, 32 - nt.bit_length())
    np.testing.assert_array_equal(np_(got.tile_stop) - np_(got.tile_start),
                                  np_(ref.tile_stop) - np_(ref.tile_start))
    for t, (a, b) in enumerate(zip(segments(ref, nt), segments(got, nt))):
        np.testing.assert_array_equal(bins[a], bins[b], err_msg=f"tile {t}")
        assert np.all(np.diff(bins[b]) >= 0)
        np.testing.assert_array_equal(np.sort(a), np.sort(b), err_msg=f"tile {t}")
    assert int(got.num_pairs) == int(ref.num_pairs)


def test_qkey_bins_match_reference_formula():
    """The depth bins are the reference's f32 formula, bit for bit."""
    w, h, tile = 96, 64, 16
    jp, tp = _inputs(w, h, 4)
    bins, qbits = _qbins(tp, w, h, tile)
    nbins = 1 << qbits
    d, vis = jp.depths, jp.visible
    dmin = jnp.min(jnp.where(vis, d, jnp.inf))
    dmax = jnp.max(jnp.where(vis, d, -jnp.inf))
    scale = (nbins - 1) / jnp.maximum(dmax - dmin, 1e-12)
    ref = jnp.floor(jnp.clip((d - dmin) * scale, 0, nbins - 1))
    np.testing.assert_array_equal(bins, np.asarray(ref))


def test_expand_plain_covers_every_slot_once():
    """Every slot below min(total, capacity) is owned by its gaussian, in
    gaussian-major order, and the static slots past the total hold the
    sentinel (tile num_tiles, depth inf, gid 0); past the capacity the back
    pairs are dropped."""
    w, h, tile = 96, 64, 16
    _, tp = _inputs(w, h, 6, big_rects=True)
    ex = TB.expand_inputs(tp, w, h, tile, tile, 1 << 20)
    total = int(ex.total)
    tile_id, depth, gid = TEX.expand_pairs(ex.itab, ex.ftab, ex.p_out,
                                           ex.num_tiles, ex.ntx, tile, tile)
    assert ex.p_out == 1 << 20 and gid.shape == (1 << 20,)
    counts = np_(ex.itab[1])
    np.testing.assert_array_equal(np_(gid)[:total],
                                  np.repeat(np.arange(300), counts))
    culled = np_(tile_id)[:total] == ex.num_tiles
    assert np.isinf(np_(depth)[:total][culled]).all() and culled.any()
    assert (np_(tile_id)[total:] == ex.num_tiles).all()
    assert np.isinf(np_(depth)[total:]).all() and not np_(gid)[total:].any()
    small = TB.expand_inputs(tp, w, h, tile, tile, total // 3)
    t2, _, g2 = TEX.expand_pairs(small.itab, small.ftab, small.p_out,
                                 small.num_tiles, small.ntx, tile, tile)
    assert small.p_out == total // 3 and int(small.total) == total
    np.testing.assert_array_equal(np_(g2), np_(gid)[: small.p_out])
    np.testing.assert_array_equal(np_(t2), np_(tile_id)[: small.p_out])


def test_clamp_tile_segments():
    w, h, tile = 64, 48, 16
    jp, tp = _inputs(w, h, 0, big_rects=True)
    ref, ref_max = JB.clamp_tile_segments(
        JB.bin_gaussians(jp, w, h, tile, tile, CAP), 7)
    got, got_max = TB.clamp_tile_segments(
        TB.bin_gaussians(tp, w, h, tile, tile, CAP), 7)
    assert int(got_max) == int(ref_max) > 7
    assert_segments_equal(ref, got, _num_tiles(w, h, tile))


@pytest.mark.parametrize("n,pair_capacity", [(1, 100), (300, 8192),
                                             (1 << 20, 1 << 21)])
def test_capacity_helpers(n, pair_capacity):
    assert TEX.expand_capacity(pair_capacity, n) == JEX.expand_capacity(
        pair_capacity, n)
    assert TB._packed_key_shift(n, 2040) == JB._packed_key_shift(n, 2040)


def _edge_scene(scene: str, w: int, h: int):
    """Screen-space scenes at the expand kernel's edges, as numpy: "behind"
    is 2,000 gaussians in view (a third of them far off screen: visible,
    but owning no tile) followed by 6,000 behind the camera (invisible, no
    tile), as pad_behind_camera lays out a large scene's view; "presorted"
    the same scene in depth order, which interleaves the in-view gaussians
    that own no tile; "cover" 2,000 in view with gaussian 1,000 covering
    every tile."""
    d = random_projection(2000, w, h, 7, big_rects=True)
    rng = np.random.default_rng(8)
    if scene == "cover":
        d["means2d"][1000] = (w / 2, h / 2)
        d["radii"][1000] = 4 * max(w, h)
        d["conic"][1000] = (1e-4, 0.0, 1e-4)
        d["opac"][1000] = 0.9
        d["visible"][1000] = True
        return d
    far = rng.uniform(0, 1, 2000) < 1 / 3
    d["means2d"][far] = (-10 * w, -10 * h)
    m = 6000
    behind = random_projection(m, w, h, 9)
    behind["visible"][:] = False
    behind["radii"][:] = 0
    behind["depths"] = rng.uniform(-10, -2, m).astype(np.float32)
    return {k: np.concatenate([d[k], behind[k]]) for k in d}


@pytest.mark.parametrize("scene", ["behind", "presorted", "cover"])
def test_expand_edges_match_pallas(monkeypatch, scene):
    """The port's expansion (expand_pairs_plain, 4-row and carry mode) and
    bin_gaussians_expand_kernel against tpugs' Pallas expand in interpret
    mode on long runs of gaussians that own no tile, on their depth-sorted
    interleaving, and on one gaussian covering every tile cut mid-span by
    the capacity: the same real pairs (tile, gid, depth, attributes) and
    bit-identical sorted segments."""
    w, h, tile = 96, 64, 16
    d = _edge_scene(scene, w, h)
    tp, jp = torch_projection(d), jax_projection(d)
    presorted = scene == "presorted"
    if presorted:
        tp, jp = TB.presort_by_depth(tp)[1], JB.presort_by_depth(jp)[1]
    full = TB.expand_inputs(tp, w, h, tile, tile, 1 << 24)
    off, cnt = np_(full.itab[0]), np_(full.itab[1])
    cap = CAP
    if scene == "cover":
        assert cnt[1000] == _num_tiles(w, h, tile)
        cap = int(off[1000]) + cnt[1000] // 2
    else:
        # Behind the camera: a tail of 6,000 that own no tile; in view, runs
        # of such gaussians between owners.
        assert (cnt[-6000:] == 0).all()
        owners = np.flatnonzero(cnt)
        assert (cnt[owners[0]:owners[-1]] == 0).sum() > 100
    outs = []
    orig = JEX.expand_pairs_pallas

    def recorded(*a, **kw):
        outs.append(np.asarray(orig(*a, **kw)))
        return outs[-1]

    monkeypatch.setattr(JEX, "expand_pairs_pallas", recorded)
    ref_b = JB.bin_gaussians_expand_kernel(jp, w, h, tile, tile, cap,
                                           interpret=True, presorted=presorted,
                                           carry_attrs=True)
    ref = outs[0]
    ex = TB.expand_inputs(tp, w, h, tile, tile, cap, presorted)
    assert ex.p_out == cap and int(ex.total) == int(full.total)
    args = (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile)
    atab = TP.gaussian_attrs(tp.means2d, tp.conic, tp.rgb, tp.opac).T.contiguous()
    four = TEX.expand_pairs_plain(*args)
    tile_id, depth, gid, attrs = (np_(x) for x in TEX.expand_pairs_plain(*args, atab))
    for a, b in zip(four, (tile_id, depth, gid)):
        np.testing.assert_array_equal(np_(a), b)
    real = tile_id < ex.num_tiles
    jreal = ref[3] > 0
    got = _by_pair(tile_id[real], gid[real], depth[real], attrs[:, real])
    exp = _by_pair(ref[0, jreal].astype(np.int32),
                   ref[2, jreal].astype(np.int32), ref[1, jreal],
                   ref[4:13, jreal])
    assert got[0].shape[0] > 0 and got[0].shape == exp[0].shape
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    got_b = TB.bin_gaussians_expand_kernel(tp, w, h, tile, tile, cap,
                                           presorted=presorted)
    assert_segments_equal(ref_b, got_b, _num_tiles(w, h, tile))
    assert bool(got_b.overflow) == (scene == "cover")

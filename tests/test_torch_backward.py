"""The training slice's gradients against tpugs on the same numpy inputs:
the backward compositor's plain version against tpugs' Pallas backward
kernel (transposed_out=True, interpret mode), the sorted segment sum's
plain version against tpugs' sorted segment-reduce kernel (interpret mode),
and render()'s gradients against jax.grad of tpugs' render(
compositor="pallas") under one seeded cotangent.

Tolerances, with their reasons:
- backward kernel, per-pair rows: rtol 1e-4 with atol 1e-5 x the row's
  largest magnitude. The reference recovers T before each entry by one
  division by a sub-wave suffix product and sums over pixels in another
  order; the port divides entry by entry. Both drift at ulp scale, and a
  pair's sum over a tile's pixels cancels, so the absolute floor scales
  with the row.
- segment sums: rtol 1e-5, atol 1e-6: the unstable sort orders each run
  differently in the two packages.
- render() gradients: rtol 1e-4 with atol 2e-5 x the array's largest
  magnitude, on every element: the above, plus projection's ulps
  (XLA's and torch's exp, sqrt and division), carried through the chain
  rule of the EWA covariance (measured: at most 3e-6 of the largest
  magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (np_, random_projection, render_grads_both,
                                torch_projection)
from tpugs.ops import rasterize_tiled as JR
from tpugs.ops.pallas.composite_t import composite_backward_pallas
from tpugs.ops.pallas.segreduce import SENTINEL as JAX_SENTINEL
from tpugs.ops.pallas.segreduce import segment_reduce_sorted_pallas
from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite_t as TC
from tpugs_torch.ops import pack as TP
from tpugs_torch.ops import rasterize_tiled as TR
from tpugs_torch.ops import segreduce as TS
from tpugs_torch.ops.composite import reduce_pair_grads
from tpugs_torch.utils.synthetic import synthetic_params_numpy
from tpugs_torch.viewer.camera import orbit_trajectory

torch.set_num_threads(1)

CAP = 8192
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
K4_RTOL, K4_ATOL_REL = 1e-4, 1e-5
SEG_RTOL, SEG_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 2e-5


def _aligned_scene(w, h, tile, seed, max_hits=512, tile_h=None):
    """Binned, packed and aligned pairs of a random screen-space scene with
    opaque centres (alpha at the 0.99 clamp) and saturated pixels; tiles
    of tile x tile_h (default square)."""
    rng = np.random.default_rng(seed)
    d = random_projection(300, w, h, seed, big_rects=True)
    d["opac"] = rng.uniform(0.3, 0.99, 300).astype(np.float32)
    d["opac"][::7] = 1.0  # opac * gauss >= 0.99 near these centres
    tp = torch_projection(d)
    tile_h = tile if tile_h is None else tile_h
    cfg = TR.RasterConfig(img_h=h, img_w=w, tile_h=tile_h, tile_w=tile,
                          pair_capacity=CAP, max_hits_per_tile=max_hits)
    b, _ = TB.clamp_tile_segments(
        TB.bin_gaussians_expand_kernel(tp, w, h, tile, tile_h, CAP), max_hits)
    astart, astop, counts = TP.aligned_offsets(b.tile_start, b.tile_stop)
    attr_c = TP.pack_compact_attrs(b.pair_gauss, tp.means2d, tp.conic, tp.rgb,
                                   tp.opac, b.pair_gauss.shape[0])
    attr = TP.align_copy(attr_c, b.tile_start, astart, counts,
                         TP.aligned_length(astart, counts))
    return cfg, astart, astop, attr


def _cotangents(cfg, seed):
    rng = np.random.default_rng(seed + 100)
    d_color = rng.normal(size=(cfg.num_tiles, cfg.pix, 3)).astype(np.float32)
    r0_scale = rng.normal(size=(cfg.num_tiles, cfg.pix)).astype(np.float32)
    return torch.from_numpy(d_color), torch.from_numpy(r0_scale)


def _written(astart, astop, p):
    """Mask of the aligned columns that hold a pair."""
    m = np.zeros(p, bool)
    for s, e in zip(np_(astart), np_(astop)):
        m[s:e] = True
    return m


def _assert_rows_close(got, ref):
    for r in range(got.shape[0]):
        scale = max(np.abs(ref[r]).max(), 1e-30)
        np.testing.assert_allclose(got[r], ref[r], rtol=K4_RTOL,
                                   atol=K4_ATOL_REL * scale, err_msg=f"row {r}")


@pytest.mark.parametrize("w,h,tile,seed", [(64, 48, 16, 0), (96, 64, 32, 1),
                                           (96, 64, 16, 2)])
def test_backward_matches_pallas_kernel(w, h, tile, seed):
    cfg, astart, astop, attr = _aligned_scene(w, h, tile, seed)
    _, final_t, _, k_last = TC.composite_forward(cfg, astart, astop, attr)
    d_color, r0_scale = _cotangents(cfg, seed)
    r0 = r0_scale * final_t
    got = np_(TC.composite_backward(cfg, astart, astop, attr, d_color, r0,
                                    final_t, k_last))
    # The reference kernel reads and writes CHUNK-wide windows past a
    # segment: pad.
    attr_j = jnp.asarray(np.pad(np_(attr), ((0, 0), (0, 1024))))
    jcfg = JR.RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=CAP, max_hits_per_tile=512)
    ref = np.asarray(composite_backward_pallas(
        jcfg, jnp.asarray(np_(astart)), jnp.asarray(np_(astop)), attr_j,
        jnp.asarray(np_(d_color)), jnp.asarray(np_(r0)),
        jnp.asarray(np_(final_t)), jnp.asarray(np_(k_last)), interpret=True,
        transposed_out=True))
    m = _written(astart, astop, attr.shape[1])
    assert got.shape == (TP.NUM_ATTR, attr.shape[1])
    _assert_rows_close(got[:, m], ref[:TP.NUM_ATTR, :attr.shape[1]][:, m])
    assert np.isfinite(got[:, m]).all()
    # The scene exercises the clamp gate and pixels that ended early.
    assert (np_(final_t) < TR.T_THRESHOLD).any()
    opac = np_(attr)[5]
    assert (opac[m] >= TR.ALPHA_CLAMP).any()
    assert (np.abs(got[5, m]) > 0).any() and (got[5, m] == 0).any()


def test_backward_tile_subset_and_zero_cotangent():
    cfg, astart, astop, attr = _aligned_scene(96, 64, 16, 3)
    _, final_t, _, k_last = TC.composite_forward(cfg, astart, astop, attr)
    d_color, r0_scale = _cotangents(cfg, 3)
    args = (cfg, astart, astop, attr, d_color, r0_scale * final_t, final_t,
            k_last)
    full = np_(TC.composite_backward_plain(*args))
    sel = torch.tensor([5, 0, 23, 11])
    sub = np_(TC.composite_backward_plain(*args, tiles=sel))
    cols = np.concatenate([np.arange(int(astart[t]), int(astop[t]))
                           for t in np_(sel)])
    np.testing.assert_array_equal(full[:, cols], sub[:, cols])
    zero = TC.composite_backward_plain(
        cfg, astart, astop, attr, torch.zeros_like(d_color),
        torch.zeros_like(final_t), final_t, k_last)
    assert not zero.any()


def test_block_sum_is_the_kernel_tree():
    """The plain version's pixel sum follows the kernel's order over
    [G, WARPS, WARP, ppt]: a thread's slots in order, the warp's shuffle-down
    tree over lanes, the warps in order, the cluster's blocks in order."""
    rng = np.random.default_rng(0)
    for g, warps, ppt in ((1, 4, 2), (4, 4, 2), (8, 8, 2), (2, 8, 1)):
        v = torch.from_numpy(rng.normal(
            size=(2, 3, g * warps * 32 * ppt)).astype(np.float32))
        got = TC._block_sum(v, warps, ppt)
        x = np_(v).reshape(2, 3, g, warps, 32, ppt)
        s = x[..., 0]
        for i in range(1, ppt):
            s = s + x[..., i]
        for off in (16, 8, 4, 2, 1):
            s = s[..., :off] + s[..., off:2 * off]
        s = s[..., 0]  # [2, 3, g, warps]
        blk = s[..., 0]
        for wi in range(1, warps):
            blk = blk + s[..., wi]
        ref = blk[..., 0]
        for b in range(1, g):
            ref = ref + blk[..., b]
        np.testing.assert_array_equal(np_(got), ref)
        np.testing.assert_allclose(np_(got), np_(v).astype(np.float64).sum(-1),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tile_w,tile_h", [(16, 16), (32, 32), (64, 64),
                                           (32, 16), (48, 24)])
def test_kernel_pixels_cover_the_tile(tile_w, tile_h):
    """In both kernels' layouts every pixel of a tile sits in exactly one
    (sub-tile, warp, lane, slot) and every warp in one compact patch; the
    backward's sub-tiles fit one cluster."""
    for backward in (False, True):
        kp = TC.kernel_pixels(tile_w, tile_h, backward)
        g, warps, _, ppt = kp.shape
        assert warps * 32 in ((128, 256) if backward else (256,))
        assert g <= TC.MAX_SUBTILES or not backward
        held = kp[kp >= 0]
        assert torch.equal(torch.sort(held).values,
                           torch.arange(tile_w * tile_h))
        for warp in kp.reshape(-1, 32 * ppt):
            warp = warp[warp >= 0]
            if warp.numel():
                x, y = warp % tile_w, warp // tile_w
                assert int(x.max() - x.min()) < 8
                assert int(y.max() - y.min()) < 4 * ppt


@pytest.mark.parametrize("w,h,tile_w,tile_h,seed", [
    (96, 64, 32, 32, 4), (128, 96, 64, 64, 5), (100, 70, 32, 16, 6)])
def test_backward_tile_subset_matches_whole_frame(w, h, tile_w, tile_h, seed):
    """Under the sub-tile tree, the plain backward gives a tile the same
    columns whether it walks alone, in a subset, or in the whole frame."""
    cfg, astart, astop, attr = _aligned_scene(w, h, tile_w, seed,
                                              tile_h=tile_h)
    _, final_t, _, k_last = TC.composite_forward(cfg, astart, astop, attr)
    d_color, r0_scale = _cotangents(cfg, seed)
    args = (cfg, astart, astop, attr, d_color, r0_scale * final_t, final_t,
            k_last)
    full = np_(TC.composite_backward_plain(*args))
    counts = np_(astop - astart)
    busiest = int(np.argmax(counts))
    for sel in ([busiest], [busiest, 0, cfg.num_tiles - 1]):
        sub = np_(TC.composite_backward_plain(*args, tiles=torch.tensor(sel)))
        cols = np.concatenate([np.arange(int(astart[t]), int(astop[t]))
                               for t in sel])
        np.testing.assert_array_equal(full[:, cols], sub[:, cols])
    assert np.abs(full).max() > 0


def _keys_and_cols(p, n, seed):
    """Slot keys with SENTINEL slots and gaussians that own no slot, and the
    9 gradient columns zero on the sentinel slots."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n, p).astype(np.int32)
    key[rng.uniform(size=p) < 0.2] = TS.SENTINEL
    key[np.isin(key, np.arange(0, n, 5))] = TS.SENTINEL  # empty gaussians
    cols = rng.normal(size=(TP.NUM_ATTR, p)).astype(np.float32)
    cols[:, key == TS.SENTINEL] = 0.0
    return key, cols


@pytest.mark.parametrize("p,n,seed", [(1000, 300, 0), (4096, 700, 1), (7, 1, 2)])
def test_segment_reduce_matches_pallas_kernel(p, n, seed):
    key, cols = _keys_and_cols(p, n, seed)
    got = np_(TS.segment_reduce_sorted(torch.from_numpy(key),
                                       torch.from_numpy(cols), n))
    keyf = np.where(key == TS.SENTINEL, JAX_SENTINEL, key).astype(np.float32)
    ref = np.asarray(segment_reduce_sorted_pallas(
        jnp.asarray(keyf), tuple(jnp.asarray(c) for c in cols), n,
        interpret=True))[:TP.NUM_ATTR]
    assert got.shape == (TP.NUM_ATTR, n)
    np.testing.assert_allclose(got, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    exact = np.zeros((TP.NUM_ATTR, n))
    ok = key != TS.SENTINEL
    np.add.at(exact.T, key[ok], cols[:, ok].T.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=SEG_RTOL, atol=SEG_ATOL)
    assert not got[:, ::5].any()  # gaussians with no slot


def test_segment_sum_plain_adds_runs_in_order():
    cols = torch.tensor([[1e8, 1.0, -1e8, 3.0, 5.0]] * TP.NUM_ATTR)
    bounds = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    got = TS.segment_sum_sorted_plain(cols, bounds, 3)
    # Run 0 is ((0 + 1e8) + 1) - 1e8 in f32 = 0: left to right, from zero.
    np.testing.assert_array_equal(np_(got)[0], np.float32([0.0, 0.0, 8.0]))


def test_reduce_masks_unwritten_slots():
    """NaN in slots the kernel leaves unwritten (alignment gaps, past the
    last tile) never reaches a gaussian's sum."""
    cfg, astart, astop, attr = _aligned_scene(64, 48, 16, 4)
    n = 300
    d = torch.zeros((TP.NUM_ATTR, attr.shape[1]))
    m = torch.from_numpy(_written(astart, astop, attr.shape[1]))
    d[:, ~m] = float("nan")
    d[:, m] = 1.0
    acc = reduce_pair_grads(d, attr, astop, n)
    gid = np_(attr)[TP.GID_ROW][np_(m)].astype(np.int64)
    assert torch.isfinite(acc).all()
    np.testing.assert_array_equal(np_(acc)[:, 0], np.bincount(gid, minlength=n))


def _model(w, h, seed, n=300):
    p = synthetic_params_numpy(n, seed=seed)
    cam = orbit_trajectory(p["means"], 4, w, h)[seed % 4]
    return p, cam.world_to_camera().astype(np.float32), cam.intrinsics_array()


def _grads_both(*args, **kw):
    return render_grads_both(*args, cap=kw.pop("cap", CAP), **kw)


def _assert_grads_close(got, ref):
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        assert np.isfinite(g).all(), f"{k}: not finite"
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale, err_msg=k)


@pytest.mark.parametrize("w,h,tile,seed,presort", [
    (64, 48, 16, 0, "exact"), (96, 64, 32, 1, False),
])
def test_render_gradients_match_jax(w, h, tile, seed, presort):
    p, vm, intr = _model(w, h, seed)
    alive = np.ones(p["means"].shape[0], bool)
    out, jo, got, ref = _grads_both(p, alive, vm, intr, w, h, tile, presort,
                                    seed=seed)
    np.testing.assert_allclose(np_(out.color), np.asarray(jo.color), atol=1e-5)
    _assert_grads_close(got, ref)
    assert np.abs(got["probe"]).max() > 0 and np.abs(got["sh"]).max() > 0


def test_render_gradients_truncated_capacity_match_jax():
    """Pairs past the capacity and entries past max_hits carry no
    gradient, in both packages."""
    p, vm, intr = _model(64, 48, 5)
    alive = np.ones(p["means"].shape[0], bool)
    out, jo, got, ref = _grads_both(p, alive, vm, intr, 64, 48, 16, "exact",
                                    cap=200, max_hits=24, seed=5)
    assert bool(out.pair_overflow) and bool(out.hit_overflow)
    assert bool(jo.pair_overflow) and bool(jo.hit_overflow)
    _assert_grads_close(got, ref)


def test_render_gradients_behind_camera_and_dead_slots():
    """Gaussians behind the camera, dead slots and degenerate scales: zero,
    finite gradients where nothing was drawn, the reference's elsewhere."""
    p, vm, intr = _model(64, 48, 2, n=200)
    rng = np.random.default_rng(9)
    center = -vm[:3, :3].T @ vm[:3, 3]
    # 25 behind the camera, 5 between it and the near plane.
    z = np.concatenate([rng.uniform(-3.0, -0.5, 25), rng.uniform(0.0, 0.19, 5)])
    off = rng.uniform(-0.3, 0.3, (30, 2))
    p["means"][:30] = (center + z[:, None] * vm[2, :3]
                       + off[:, :1] * vm[0, :3] + off[:, 1:] * vm[1, :3])
    cam_z = (p["means"] @ vm[:3, :3].T + vm[:3, 3])[:, 2]
    p["log_scales"][40:50] = -30.0  # scales that underflow
    alive = np.ones(200, bool)
    alive[60:90] = False
    out, jo, got, ref = _grads_both(p, alive, vm, intr, 64, 48, 16, False,
                                    seed=2)
    assert (cam_z[:30] <= 0.2).all() and not np_(out.visible)[:30].any()
    _assert_grads_close(got, ref)
    for k in NAMES + ("probe",):
        assert not got[k][60:90].any(), k  # dead slots
    hidden = ~np_(out.visible)
    assert not got["means"][hidden].any()


def test_projection_vjp_matches_jax():
    """project_gaussians' VJP against jax.vjp under one seeded cotangent of
    every float field, with gaussians behind the camera, between it and the
    near plane, dead, and with degenerate scales: finite everywhere."""
    from tpugs.ops.projection import project_gaussians as jax_project
    from tpugs_torch.ops.projection import project_gaussians

    p, vm, intr = _model(64, 48, 1, n=120)
    center = -vm[:3, :3].T @ vm[:3, 3]
    z = np.linspace(-2.0, 0.19, 20)
    p["means"][:20] = center + z[:, None] * vm[2, :3]
    p["log_scales"][20:25] = -30.0
    # Colour exactly 0 (a tie of the clamp at 0): half the gradient passes,
    # as through jnp.maximum.
    p["sh"][40:45] = 0.0
    p["sh"][40:45, :, 0] = np.float32(-0.5) / np.float32(0.28209479177387814)
    alive = np.ones(120, bool)
    alive[30:40] = False
    fields = ("means2d", "depths", "conic", "rgb", "opac")
    rng = np.random.default_rng(11)
    cots = {}

    def jfn(*args):
        o = jax_project(*args, jnp.asarray(alive), jnp.asarray(vm),
                        jnp.asarray(intr), 64, 48, 3)
        return tuple(getattr(o, f) for f in fields)

    outs, vjp = jax.vjp(jfn, *[jnp.asarray(p[k]) for k in NAMES])
    for f, o in zip(fields, outs):
        cots[f] = rng.normal(size=o.shape).astype(np.float32)
    ref = vjp(tuple(jnp.asarray(cots[f]) for f in fields))

    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    o = project_gaussians(*[tp[k] for k in NAMES], torch.from_numpy(alive),
                          torch.from_numpy(vm), torch.from_numpy(intr), 64, 48, 3)
    loss = sum((getattr(o, f) * torch.from_numpy(cots[f])).sum() for f in fields)
    got = torch.autograd.grad(loss, [tp[k] for k in NAMES])
    for k, g, r in zip(NAMES, got, ref):
        g, r = np_(g), np.asarray(r)
        assert np.isfinite(g).all(), k
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale,
                                   err_msg=k)
    assert not np_(o.visible)[:20].any()
    assert not np_(o.rgb)[40:45].any() and not np.asarray(outs[3])[40:45].any()

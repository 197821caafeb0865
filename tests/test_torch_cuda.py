"""The port's CUDA kernels against their plain versions on the card, and a
render and its gradients on the card against the same on the CPU. Marked `cuda`: they
skip where there is no NVIDIA GPU (with nvcc). They import no JAX, so on a
card machine without it run them past tests/conftest.py (which imports JAX):
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`."""
import numpy as np
import pytest
import torch

from tpugs_torch import cuda_lib
from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite_t, expand, pack, segreduce
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.utils.synthetic import (pad_behind_camera,
                                         synthetic_intrinsics_numpy,
                                         synthetic_params_numpy)
from tpugs_torch.viewer.camera import orbit_trajectory

NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def np_(t):
    return t.cpu().numpy()


def _proj(dev, w, h, seed, n=2000, n_total=None):
    """A seeded scene of n gaussians projected on the identity view; with
    n_total, followed by n_total - n behind the camera."""
    p = params_from_numpy(synthetic_params_numpy(n, seed=seed), dev)
    if n_total is not None:
        p = pad_behind_camera(p, n_total)
        n = n_total
    return project_gaussians(
        *[p[k] for k in NAMES], torch.ones(n, dtype=torch.bool, device=dev),
        torch.eye(4, device=dev),
        torch.as_tensor(synthetic_intrinsics_numpy(w, h), device=dev), w, h, 3)


def _frame_expand(proj, tile, frac=1.0, presorted=False, qbits=0):
    """The expand kernel's arguments for a projected frame at 192x128, the
    capacity at `frac` of its pairs."""
    if presorted:
        proj = TB.presort_by_depth(proj)[1]
    total = TB.expand_inputs(proj, 192, 128, tile, tile, 1 << 24).total
    ex = TB.expand_inputs(proj, 192, 128, tile, tile, int(total * frac),
                          presorted, qbits)
    atab = pack.gaussian_attrs(proj.means2d, proj.conic, proj.rgb,
                               proj.opac).T.contiguous()
    return (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile), atab


def _table_expand(dev, n, ntx, nty, seed, zero=(), cover=(), cut=None):
    """The expand kernel's arguments for a synthetic table of n gaussians on
    an ntx x nty grid of 16-pixel tiles: rects of up to 3 x 3 tiles, centres
    and cull radii that cull some of their corners, count 0 for the
    gaussians in `zero` (w stays >= 1), every tile for those in `cover`.
    cut(offsets, counts) -> p_out, else every pair."""
    rng = np.random.default_rng(seed)
    w = np.minimum(rng.integers(1, 4, n), ntx)
    h = np.minimum(rng.integers(1, 4, n), nty)
    tx0 = rng.integers(0, ntx - w + 1)
    ty0 = rng.integers(0, nty - h + 1)
    cover = list(cover)
    tx0[cover], ty0[cover], w[cover], h[cover] = 0, 0, ntx, nty
    cnt = w * h
    cnt[list(zero)] = 0
    off = np.cumsum(cnt) - cnt
    p_out = int(cnt.sum()) if cut is None else cut(off, cnt)
    gx = (tx0 + rng.uniform(0, 1, n) * w) * 16
    gy = (ty0 + rng.uniform(0, 1, n) * h) * 16
    r2 = (rng.uniform(0.3, 1.5, n) * 16 * np.maximum(w, h)) ** 2
    itab = np.stack([off, cnt, tx0, ty0, w]).astype(np.int32)
    ftab = np.stack([gx, gy, r2, rng.uniform(0.5, 20, n)]).astype(np.float32)
    atab = rng.normal(size=(expand.ATAB_ROWS, n)).astype(np.float32)
    itab, ftab, atab = (torch.from_numpy(a).to(dev) for a in (itab, ftab, atab))
    return (itab, ftab, p_out, ntx * nty, ntx, 16, 16), atab


def _zero_runs(n, seed):
    """Gaussians that own no slot: four whole chunks of 512 (eight of 256),
    a third of the rest at random, runs of 5 to 40 across warp bounds and
    a tail of 800, as behind the camera."""
    rng = np.random.default_rng(seed)
    zero = set(range(1024, 3072)) | set(range(n - 800, n))
    zero |= set(np.flatnonzero(rng.uniform(0, 1, n) < 1 / 3).tolist())
    for start in rng.integers(0, n - 40, 20):
        zero |= set(range(start, start + rng.integers(5, 41)))
    return sorted(zero)


# The expand kernel's edges (csrc/expand.cu: one block per chunk of 512
# gaussians, 256 in carry mode): names -> the kernel's arguments and an
# attribute table for carry mode.
EXPAND_EDGES = {
    # Long runs of count-0 gaussians: whole chunks, partial warps, a tail;
    # n = 5000 is no multiple of the chunk.
    "zero-runs": lambda dev: _table_expand(dev, 5000, 12, 8, 0,
                                           zero=_zero_runs(5000, 0)),
    # One gaussian (and a second) on every tile of a 1080p frame at tiles
    # of 16: its span crosses several chunks' worth of slots.
    "cover": lambda dev: _table_expand(dev, 3000, 120, 68, 1, cover=(700, 2500),
                                       zero=range(100, 400)),
    # p_out inside the covering gaussian's span, so inside its chunk.
    "cut-in-gaussian": lambda dev: _table_expand(
        dev, 3000, 120, 68, 2, cover=(1500,),
        cut=lambda off, cnt: int(off[1500] + cnt[1500] // 3)),
    # p_out at the first slot of gaussian 1024: the chunks from there on
    # start at or past it.
    "cut-at-chunk": lambda dev: _table_expand(
        dev, 5000, 12, 8, 3, cut=lambda off, cnt: int(off[1024])),
    "n1": lambda dev: _table_expand(dev, 1, 12, 8, 4),
    "n0": lambda dev: _table_expand(dev, 0, 12, 8, 5),
    "p0": lambda dev: _table_expand(dev, 100, 12, 8, 6, cut=lambda o, c: 0),
    # A projected scene of 2000 followed by 5000 behind the camera, as
    # pad_behind_camera lays out the 2^24 step; then in depth order, where
    # the gaussians that own no tile interleave.
    "behind": lambda dev: _frame_expand(_proj(dev, 192, 128, 0, 2000, 7000), 16),
    "behind-presorted": lambda dev: _frame_expand(
        _proj(dev, 192, 128, 0, 2000, 7000), 32, presorted=True),
}


@pytest.mark.parametrize("case", [
    (16, 0, False, 1.0), (32, 0, False, 0.5), (16, 32, False, 1.0), (32, 0, True, 1.0),
    (16, 0, False, 1.5), *EXPAND_EDGES])
def test_expand_kernel_bit_identical(dev, case):
    """K1 against its plain version: frames at tiles of 16 and 32 (tile,
    qbits, presorted, capacity fraction) and the kernel's edges."""
    if isinstance(case, str):
        args, _ = EXPAND_EDGES[case](dev)
    else:
        tile, qbits, presorted, frac = case
        args, _ = _frame_expand(_proj(dev, 192, 128, 0), tile, frac, presorted,
                                qbits)
    got = expand.expand_pairs(*args)
    assert all(x.shape == (args[2],) for x in got)
    for a, b in zip(got, expand.expand_pairs_plain(*args)):
        assert torch.equal(a, b)


# Tiles of 16 (one sub-tile), 32 (four), 64 (the backward's eight of 32x16)
# and a rectangular one, each with an image size; 200x136 leaves a ragged
# edge on both axes.
TILES = [(16, 16, 192, 128), (32, 32, 192, 128), (64, 64, 192, 128),
         (32, 16, 200, 136)]


@pytest.mark.parametrize("tile_w,tile_h,w,h", TILES)
def test_align_copy_and_compositor(dev, tile_w, tile_h, w, h):
    proj = _proj(dev, w, h, 1)
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile_h, tile_w=tile_w,
                       pair_capacity=1 << 20, max_hits_per_tile=1 << 16)
    b = TB.bin_gaussians_expand_kernel(proj, w, h, tile_w, tile_h,
                                       cfg.pair_capacity)
    astart, astop, counts = pack.aligned_offsets(b.tile_start, b.tile_stop)
    attr_c = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                     proj.rgb, proj.opac, b.pair_gauss.shape[0])
    pal = pack.aligned_length(astart, counts)
    attr = pack.align_copy(attr_c, b.tile_start, astart, counts, pal)
    assert torch.equal(attr, pack.align_copy_plain(attr_c, b.tile_start, astart,
                                                   counts, pal))
    got = composite_t.composite_forward(cfg, astart, astop, attr)
    ref = composite_t.composite_forward_plain(cfg, astart, astop, attr)
    for a, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(np_(a), np_(r), atol=1e-5)
    for a, r in zip(got[2:], ref[2:]):
        assert (a == r).float().mean() >= 0.999


def _layout(seed, num_tiles, big, empty, extra_cols):
    """A synthetic align-copy input: compact segments with gaps between
    them, a share `empty` of empty tiles, one tile of `big` entries, and an
    output `extra_cols` past the last tile's padded end."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    counts = torch.randint(0, 300, (num_tiles,), generator=g, dtype=torch.int32)
    counts[torch.rand(num_tiles, generator=g) < empty] = 0
    counts[num_tiles // 3] = big
    gaps = torch.randint(0, 5, (num_tiles,), generator=g, dtype=torch.int32)
    tile_start = (torch.cumsum(counts + gaps, 0) - counts).int()
    attr_c = torch.randn((pack.ATTR_ROWS, int(tile_start[-1] + counts[-1]) + 3),
                         generator=g)
    stop = tile_start + counts
    astart, _, counts = pack.aligned_offsets(tile_start, stop)
    pal = pack.aligned_length(astart, counts) + extra_cols
    return attr_c, tile_start, astart, counts, pal


@pytest.mark.parametrize("num_tiles,big,empty,extra_cols", [
    (3000, 8192, 0.3, 0),  # more than two waves of the one-block-per-tile
    #                         design, one 8,192-entry tile
    (2040, 22848, 0.0, 0),  # the render frame's busiest tile
    (500, 8192, 0.95, 5),  # mostly empty tiles; rows not 16-byte aligned
    (7, 1, 0.0, 131),  # a few tiles and a zero tail past the last one
])
def test_align_copy_layouts_bit_identical(dev, num_tiles, big, empty,
                                          extra_cols):
    """K2 against its plain version on layouts the render frames do not
    all reach: every output column, gaps and tail included."""
    args = _layout(num_tiles, num_tiles, big, empty, extra_cols)
    on_card = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    got = pack.align_copy(*on_card)
    assert torch.equal(got.cpu(), pack.align_copy_plain(*args))
    cuda_lib.check_guards()


@pytest.mark.parametrize("case", ["interval past exp_end",
                                  "interval before 0",
                                  "segment past attr_c",
                                  "segment past p_aligned",
                                  "segment off the 128 grid",
                                  "forward segment past P_al",
                                  "backward segment reversed"])
def test_contract_violation_raises(dev, case):
    """K6, K2, K3 and K4 check their inputs' contract on the card instead
    of reading them back: a violation is not read or written past, and
    raises at the next check once the stream has passed the kernel."""
    if case.startswith(("forward", "backward")):
        cfg, astart, astop, attr = (a.to(dev) if isinstance(a, torch.Tensor)
                                    else a for a in _walk_scene(32, 32, 1))
        bad = 3
        fwd = composite_t.composite_forward(cfg, astart, astop, attr)
        ok = torch.arange(cfg.num_tiles, device=dev) != bad
        if case.startswith("forward"):
            stop = astop.clone()
            stop[bad] = attr.shape[1] + 5
            got = composite_t.composite_forward(cfg, astart, stop, attr)
            torch.cuda.synchronize()
            for a, r in zip(got, fwd):
                assert torch.equal(a[ok], r[ok])
            assert (got[1][bad] == 1).all() and (got[3][bad] == -1).all()
        else:
            start = astart.clone()
            start[bad] = astop[bad] + 1
            g = torch.Generator(device="cpu").manual_seed(7)
            d_color = torch.randn((cfg.num_tiles, cfg.pix, 3), generator=g).to(dev)
            args = (cfg, astart, astop, attr, d_color, fwd[1], fwd[1], fwd[3])
            ref = composite_t.composite_backward(*args)
            got = composite_t.composite_backward(cfg, start, *args[2:])
            torch.cuda.synchronize()
            cols = torch.cat([torch.arange(int(astart[t]), int(astop[t]))
                              for t in range(cfg.num_tiles) if t != bad]).to(dev)
            assert torch.equal(got[:, cols], ref[:, cols])
        what = f"tile {bad} has a segment"
    elif case.startswith("interval"):
        start = torch.tensor([0, 2, 5, 5, 9], dtype=torch.int32)
        count = torch.tensor([2, 3, 0, 4, 2], dtype=torch.int32)
        if case == "interval before 0":
            start[1] = -1
        else:
            count[4] = 3  # 9 + 3 > 11
        rows = torch.randn((12, pack.NUM_ATTR))
        launches = segreduce.segment_reduce.launches
        got = segreduce.segment_reduce(rows.to(dev), start.to(dev),
                                       count.to(dev), 11, 5)
        bad = 1 if case == "interval before 0" else 4
        what = f"gaussian {bad} has an interval"
        assert segreduce.segment_reduce.launches == launches + 1
        torch.cuda.synchronize()
        ok = torch.arange(5) != bad
        ref = segreduce.segment_reduce_plain(rows, start, count, 5)
        assert torch.equal(got.cpu()[:, ok], ref[:, ok])
        assert torch.isnan(got[:, bad]).all()
    else:
        attr_c, tile_start, astart, counts, pal = _layout(1, 40, 300, 0.2, 0)
        bad = 17
        if case == "segment past attr_c":
            tile_start[bad] = attr_c.shape[1] - 2
            counts[bad] = max(int(counts[bad]), 5)
        elif case == "segment past p_aligned":
            bad = 39
            pal -= 1
        else:
            astart[bad] += 4
        what = f"tile {bad} has a segment"
        pack.align_copy(attr_c.to(dev), tile_start.to(dev), astart.to(dev),
                        counts.to(dev), pal)
        torch.cuda.synchronize()
    with pytest.raises(ValueError, match=what):
        cuda_lib.check_guards()
    cuda_lib.check_guards()  # the word was cleared


@pytest.mark.parametrize("kernel", ["align_copy", "segment_reduce",
                                    "composite_forward", "composite_backward",
                                    "expand", "expand_carry"])
def test_wrapper_makes_no_host_read(dev, kernel):
    """K2's, K6's, K3's and K4's wrappers check their inputs' contract on
    the card, and K1's reads nothing back either: a call makes the host
    wait for the device nowhere (torch's sync debug mode raises where an
    operation would)."""
    if kernel.startswith("expand"):
        args, atab = EXPAND_EDGES["zero-runs"](dev)
        args += (atab,) if kernel == "expand_carry" else ()
        call = lambda: expand.expand_pairs(*args)
    elif kernel.startswith("composite"):
        cfg, astart, astop, attr = (a.to(dev) if isinstance(a, torch.Tensor)
                                    else a for a in _walk_scene(32, 32, 2))
        _, final_t, _, k_last = composite_t.composite_forward(cfg, astart,
                                                              astop, attr)
        d_color = torch.ones((cfg.num_tiles, cfg.pix, 3), device=dev)
        if kernel == "composite_forward":
            call = lambda: composite_t.composite_forward(cfg, astart, astop, attr)
        else:
            call = lambda: composite_t.composite_backward(
                cfg, astart, astop, attr, d_color, final_t, final_t, k_last)
    elif kernel == "align_copy":
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in _layout(2, 300, 8192, 0.2, 0)]
        call = lambda: pack.align_copy(*args)
    else:
        rows = torch.randn((64, pack.NUM_ATTR), device=dev)
        iv = torch.arange(0, 64, 4, dtype=torch.int32, device=dev)
        call = lambda: segreduce.segment_reduce(rows, iv, torch.full_like(iv, 4),
                                                64, 16)
    call()  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    cuda_lib.check_guards()


def test_contract_violation_raises_at_the_next_launch(dev):
    """After a synchronising read, the next launch of any kernel of the
    library reports an earlier launch's violation, before it launches."""
    rows = torch.randn((4, pack.NUM_ATTR), device=dev)
    iv = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    segreduce.segment_reduce(rows, iv, iv + 1, 3, 2)  # 2 + 3 > 3
    torch.cuda.synchronize()
    launches = pack.align_copy.launches
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a
            for a in _layout(3, 20, 100, 0.2, 0)]
    with pytest.raises(ValueError, match="gaussian 1 has an interval"):
        pack.align_copy(*args)
    assert pack.align_copy.launches == launches
    pack.align_copy(*args)  # the word was cleared
    torch.cuda.synchronize()
    cuda_lib.check_guards()


@pytest.mark.parametrize("kernel", ["align_copy", "composite_forward"])
def test_render_cli_raises_on_a_violation_in_its_last_frame(dev, monkeypatch,
                                                            tmp_path, kernel):
    """The align-copy (a tile start off the 128 grid) or the forward
    compositor (the last tile's segment past P_al) of the render CLI's one
    and last frame breaks its contract: the CLI raises and writes no
    frame."""
    from tpugs_torch.apps import render as render_app
    from tpugs_torch.io.ply import write_gaussian_ply_numpy

    if kernel == "align_copy":
        real = pack.align_copy

        def broken(attr_c, tile_start, astart, counts, p_aligned):
            astart = astart.clone()
            astart[-1] += 4
            return real(attr_c, tile_start, astart, counts, p_aligned)

        module, match = pack, "tpugs_align_copy: .*has a segment"
    else:
        real = composite_t.composite_forward

        def broken(cfg, astart, astop, sorted_attr, row_offset=0):
            astop = astop.clone()
            astop[-1] = sorted_attr.shape[1] + 1
            return real(cfg, astart, astop, sorted_attr, row_offset)

        module, match = composite_t, "tpugs_composite_fwd: .*has a segment"
    broken.launches = 0  # the real wrapper counts on the module's name
    monkeypatch.setattr(module, kernel, broken)
    p = synthetic_params_numpy(3000, seed=2)
    ply = tmp_path / "m.ply"
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    with pytest.raises(ValueError, match=match):
        render_app.main(["-m", str(ply), "-o", str(tmp_path / "f"),
                         "--frames", "1", "--width", "160", "--height", "96",
                         "--pair-capacity", str(1 << 18), "--max-hits", "4096"])
    assert broken.launches == 1
    assert not (tmp_path / "f" / "frame_0000.png").exists()


@pytest.mark.parametrize("kernel", ["segment_reduce", "composite_backward"])
def test_trainer_raises_on_a_violation_in_its_last_step(dev, monkeypatch,
                                                        tmp_path, kernel):
    """The interval segment sum of the Trainer's one and last step (the
    classic backward) gets an interval before slot 0, or its backward
    compositor (the sorted backward) a reversed segment for tile 0. No
    kernel of the library launches after the interval sum in that run, and
    the compositor's violation may be found at the segment sum's launch or
    later: either way the Trainer raises before it logs or saves a
    checkpoint."""
    from tpugs_torch.ops import composite
    from tpugs_torch.train.trainer import TrainConfig, Trainer
    from tpugs_torch.utils.gt_scene import make_gt_model, write_gt_dataset

    if kernel == "segment_reduce":
        real = segreduce.segment_reduce

        def broken(rows, red_start, red_count, exp_end, n):
            red_start = red_start.clone()
            red_start[0] = -1
            return real(rows, red_start, red_count, exp_end, n)

        monkeypatch.setattr(composite, "SORTED_SEGRED_MIN", 1 << 62)
        module, match = segreduce, "tpugs_segreduce_interval: .*gaussian 0"
    else:
        real = composite_t.composite_backward

        def broken(cfg, astart, *args, **kw):
            astart = astart.clone()
            astart[0] = astart[0] + (1 << 20)
            return real(cfg, astart, *args, **kw)

        broken.launches_entry_major = 0
        module, match = composite_t, "tpugs_composite_bwd: .*tile 0 "
    broken.launches = 0  # the real wrapper counts on the module's name
    monkeypatch.setattr(module, kernel, broken)
    root = str(tmp_path / "gt")
    write_gt_dataset(root, make_gt_model(500, seed=0, device="cpu"),
                     num_views=4, width=64, height=48, sparse_points=200)
    out = tmp_path / "o"
    tr = Trainer(root, TrainConfig(iterations=1, log_every=1, save_every=0,
                                   densify_mode="none", tile_h=16, tile_w=16,
                                   output_dir=str(out)),
                 log_fn=lambda *_: None, device="cuda")
    with pytest.raises(ValueError, match=match):
        tr.train(1)
    assert broken.launches == 1
    assert not list(out.glob("model_*")) and not list(out.glob("ckpt_*"))


def test_render_on_card_matches_cpu(dev):
    p = synthetic_params_numpy(3000, seed=2)
    cam = orbit_trajectory(p["means"], 4, 160, 96)[1]
    cfg = RasterConfig(img_h=96, img_w=160, tile_h=16, tile_w=16,
                       pair_capacity=1 << 18, max_hits_per_tile=4096)
    outs = []
    for d in (dev, torch.device("cpu")):
        tp = params_from_numpy(p, d)
        outs.append(render(
            *[tp[k] for k in NAMES],
            torch.ones(3000, dtype=torch.bool, device=d),
            torch.as_tensor(cam.world_to_camera(), dtype=torch.float32, device=d),
            torch.as_tensor(cam.intrinsics_array(), device=d), cfg, 3,
            torch.zeros(3, device=d), need_grads=False))
    # Projection runs torch's CUDA math on one side and its CPU math on the
    # other (ulp apart), which can move a rare rect or cull boundary: hold
    # all but 0.1% of pixels to 1e-4 and the pair counts to 0.01%.
    diff = np.abs(np_(outs[0].color) - np_(outs[1].color))
    assert (diff > 1e-4).mean() < 1e-3
    pairs = [int(o.num_pairs) for o in outs]
    assert abs(pairs[0] - pairs[1]) <= 1e-4 * pairs[1]


@pytest.mark.parametrize("tile", [16, 32])
def test_cached_viewer_frame_on_card(dev, tile):
    """The viewer's cached frame at its anchor is render(presort="qkey",
    need_grads=False) on the card, bit for bit; render_cached launches the
    forward compositor alone and makes no host read; a frame 0.1 degree
    away is held to the same frame on the CPU as render()'s."""
    from tpugs_torch.ops.render_cached import build_frame_cache, render_cached

    p = synthetic_params_numpy(3000, seed=2)
    cams = orbit_trajectory(p["means"], 3600, 160, 96)[:2]  # 0.1 deg apart
    cfg = RasterConfig(img_h=96, img_w=160, tile_h=tile, tile_w=tile,
                       pair_capacity=1 << 18, max_hits_per_tile=4096)
    frames = []
    for d in (dev, torch.device("cpu")):
        tp = params_from_numpy(p, d)
        scene = [tp[k] for k in NAMES] + [
            torch.ones(3000, dtype=torch.bool, device=d)]
        vms = [torch.as_tensor(c.world_to_camera(), dtype=torch.float32,
                               device=d) for c in cams]
        it = torch.as_tensor(cams[0].intrinsics_array(), device=d)
        bg = torch.zeros(3, device=d)
        cache = build_frame_cache(*scene, vms[0], it, cfg, 3)
        exact = render(*scene, vms[0], it, cfg, 3, bg, presort="qkey",
                       need_grads=False)
        color, final_t = render_cached(cache, vms[0], it, cfg, bg)
        assert torch.equal(color, exact.color)
        assert torch.equal(final_t, exact.final_T)
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = (expand.expand_pairs.launches, pack.align_copy.launches,
                      composite_t.composite_forward.launches)
            torch.cuda.set_sync_debug_mode("error")
            try:
                color, _ = render_cached(cache, vms[1], it, cfg, bg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert (expand.expand_pairs.launches, pack.align_copy.launches,
                    composite_t.composite_forward.launches) == (
                counts[0], counts[1], counts[2] + 1)
            cuda_lib.check_guards()
        else:
            color, _ = render_cached(cache, vms[1], it, cfg, bg)
        frames.append(np_(color))
    diff = np.abs(frames[0] - frames[1])
    assert (diff > 1e-4).mean() < 1e-3


def _aligned(dev, w, h, tile_w, tile_h, seed):
    proj = _proj(dev, w, h, seed)
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile_h, tile_w=tile_w,
                       pair_capacity=1 << 20, max_hits_per_tile=1 << 16)
    b = TB.bin_gaussians_expand_kernel(proj, w, h, tile_w, tile_h,
                                       cfg.pair_capacity)
    astart, astop, counts = pack.aligned_offsets(b.tile_start, b.tile_stop)
    attr_c = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                     proj.rgb, proj.opac, b.pair_gauss.shape[0])
    attr = pack.align_copy(attr_c, b.tile_start, astart, counts,
                           pack.aligned_length(astart, counts))
    return cfg, astart, astop, attr


@pytest.mark.parametrize("tile_w,tile_h,w,h", TILES)
def test_backward_kernel_bit_identical(dev, tile_w, tile_h, w, h):
    """The backward kernel against its plain version on the slots that hold
    a pair: the same arithmetic in the same order (round-to-nearest
    intrinsics, the plain version repeating the kernel's summation tree)."""
    cfg, astart, astop, attr = _aligned(dev, w, h, tile_w, tile_h, 3)
    _, final_t, _, k_last = composite_t.composite_forward(cfg, astart, astop, attr)
    g = torch.Generator(device="cpu").manual_seed(tile_w)
    d_color = torch.randn((cfg.num_tiles, cfg.pix, 3), generator=g).to(dev)
    r0 = torch.randn((cfg.num_tiles, cfg.pix), generator=g).to(dev) * final_t
    args = (cfg, astart, astop, attr, d_color, r0, final_t, k_last)
    got = composite_t.composite_backward(*args)
    ref = composite_t.composite_backward_plain(*args)
    valid = attr[pack.VALID_ROW] > 0
    assert torch.isfinite(got[:, valid]).all()
    assert torch.equal(got[:, valid], ref[:, valid])


@pytest.mark.parametrize("p,n", [(100_000, 20_000), (5, 3), (4096, 1)])
def test_segment_sum_kernel_bit_identical(dev, p, n):
    g = torch.Generator(device="cpu").manual_seed(p)
    key = torch.randint(0, n, (p,), generator=g, dtype=torch.int32)
    key[torch.rand(p, generator=g) < 0.2] = segreduce.SENTINEL
    cols = torch.randn((pack.NUM_ATTR, p), generator=g)
    cols[:, key == segreduce.SENTINEL] = 0.0
    scols, bounds = segreduce.sort_by_key(key.to(dev), cols.to(dev), n)
    got = segreduce.segment_sum_sorted(scols, bounds, n)
    assert torch.equal(got, segreduce.segment_sum_sorted_plain(scols, bounds, n))
    ref = torch.zeros((pack.NUM_ATTR, n), dtype=torch.float64)
    ok = key != segreduce.SENTINEL
    ref.index_add_(1, key[ok].long(), cols[:, ok].double())
    np.testing.assert_allclose(np_(got), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_render_gradients_on_card_match_cpu(dev):
    p = synthetic_params_numpy(3000, seed=4)
    cam = orbit_trajectory(p["means"], 4, 160, 96)[2]
    cfg = RasterConfig(img_h=96, img_w=160, tile_h=16, tile_w=16,
                       pair_capacity=1 << 18, max_hits_per_tile=4096)
    c = torch.randn((96, 160, 3), generator=torch.Generator().manual_seed(0))
    grads = []
    for d in (dev, torch.device("cpu")):
        tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, d).items()}
        out = render(
            *[tp[k] for k in NAMES],
            torch.ones(3000, dtype=torch.bool, device=d),
            torch.as_tensor(cam.world_to_camera(), dtype=torch.float32, device=d),
            torch.as_tensor(cam.intrinsics_array(), device=d), cfg, 3,
            torch.zeros(3, device=d))
        gs = torch.autograd.grad((out.color * c.to(d)).sum(),
                                 [tp[k] for k in NAMES])
        grads.append([np_(x) for x in gs])
    # As for the image: projection is ulps apart between the devices, which
    # can move a rare rect or cull boundary and so one gaussian's gradient.
    for name, a, b in zip(NAMES, *grads):
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max()
        close = np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-4 * scale
        assert close.mean() >= 0.999, (name, close.mean())


@pytest.mark.parametrize("tile_w,tile_h,w,h", TILES)
def test_entry_major_backward_kernel_bit_identical(dev, tile_w, tile_h, w, h):
    """K4b: the entry-major layout against its plain version and against
    the attribute-major kernel transposed, on the slots that hold a pair."""
    cfg, astart, astop, attr = _aligned(dev, w, h, tile_w, tile_h, 5)
    _, final_t, _, k_last = composite_t.composite_forward(cfg, astart, astop, attr)
    g = torch.Generator(device="cpu").manual_seed(tile_w + 1)
    d_color = torch.randn((cfg.num_tiles, cfg.pix, 3), generator=g).to(dev)
    r0 = torch.randn((cfg.num_tiles, cfg.pix), generator=g).to(dev) * final_t
    args = (cfg, astart, astop, attr, d_color, r0, final_t, k_last)
    got = composite_t.composite_backward(*args, transposed_out=False)
    ref = composite_t.composite_backward_plain(*args, transposed_out=False)
    valid = attr[pack.VALID_ROW] > 0
    assert got.shape == (attr.shape[1], pack.NUM_ATTR)
    assert torch.isfinite(got[valid]).all()
    assert torch.equal(got[valid], ref[valid])
    assert torch.equal(got[valid], composite_t.composite_backward(*args).T[valid])


def _walk_scene(tile_w, tile_h, seed=0):
    """A hand-built aligned table on 3x2 tiles, the last column and row
    ragged. Each tile first holds small opaque gaussians on a 2-pixel grid
    over its left half and top 16 rows or half (the forward's first
    sub-tile at tiles of 32, its first four at 64), then faint wide ones
    (alpha ~0.005), every 50th a thin ellipse with a strong cross term. Tile
    0 holds 2,500 entries, so its walk runs past three batches of the
    forward (256 entries) and many of the backward (64) while the pixels
    under the opaque ones stop within the first batch. The other tiles
    hold 0-600 entries (tile 2 none)."""
    g = np.random.default_rng(seed)
    cfg = RasterConfig(img_h=tile_h + tile_h // 2, img_w=2 * tile_w + tile_w // 2,
                       tile_h=tile_h, tile_w=tile_w, pair_capacity=1 << 20,
                       max_hits_per_tile=1 << 16)
    counts = g.integers(0, 600, cfg.num_tiles)
    counts[0], counts[2] = 2500, 0
    padded = (counts + 127) // 128 * 128
    astart = np.cumsum(padded) - padded
    attr = np.zeros((pack.ATTR_ROWS, int(padded.sum())), np.float32)
    for t, n in enumerate(counts):
        x0, y0 = (t % cfg.ntx) * tile_w, (t // cfg.ntx) * tile_h
        sig, op = np.full(n, 40.0), np.full(n, 0.006)
        x, y = x0 + g.uniform(0, tile_w, n), y0 + g.uniform(0, tile_h, n)
        gx, gy = np.meshgrid(np.arange(-1.5, tile_w / 2 + 2, 2.0),
                             np.arange(-1.5, max(tile_h / 2, 16) + 2, 2.0))
        k = min(n, gx.size)
        sig[:k], op[:k] = 2.0, 0.95
        x[:k], y[:k] = x0 + gx.flat[:k], y0 + gy.flat[:k]
        c = slice(astart[t], astart[t] + n)
        attr[0, c], attr[1, c] = x, y
        attr[2, c] = attr[4, c] = -0.5 / sig**2
        attr[3, c] = g.uniform(-1e-4, 1e-4, n)
        # Past the skew for which the forward bounds an entry by a box.
        attr[3, c][::50] = -1.999 * 0.5 / sig[::50] ** 2
        attr[5, c] = op
        attr[6:9, c] = g.uniform(0, 1, (3, n))
        attr[pack.GID_ROW, c] = np.arange(n)
        attr[pack.VALID_ROW, c] = 1.0
    astart = torch.from_numpy(astart.astype(np.int32))
    return (cfg, astart, astart + torch.from_numpy(counts.astype(np.int32)),
            torch.from_numpy(attr))


@pytest.mark.parametrize("tile_w,tile_h", [t[:2] for t in TILES])
def test_compositors_on_long_and_uneven_walks(dev, tile_w, tile_h):
    """K3, K4 and K4b against their plain versions where a tile walks more
    than three batches and its sub-tiles (or, at G = 1, its warps) stop at
    different entries."""
    cfg, astart, astop, attr = (a.to(dev) if isinstance(a, torch.Tensor)
                                else a for a in _walk_scene(tile_w, tile_h))
    got = composite_t.composite_forward(cfg, astart, astop, attr)
    ref = composite_t.composite_forward_plain(cfg, astart, astop, attr)
    for a, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(np_(a), np_(r), atol=1e-5)
    for a, r in zip(got[2:], ref[2:]):
        assert (a == r).float().mean() >= 0.999
    k_last = got[3]
    # The last contributor of each sub-tile (of each warp at G = 1).
    kp = composite_t.kernel_pixels(tile_w, tile_h, False, dev)
    held = k_last[0][kp.clamp(min=0)].masked_fill(kp < 0, -1)
    per_unit = held.amax((1, 2, 3)) if kp.shape[0] > 1 else held.amax((0, 2, 3))
    assert int(k_last[0].max()) >= 3 * 256
    assert int(per_unit.min()) < 256 <= int(per_unit.max())
    g = torch.Generator(device="cpu").manual_seed(tile_w + tile_h)
    d_color = torch.randn((cfg.num_tiles, cfg.pix, 3), generator=g).to(dev)
    r0 = torch.randn((cfg.num_tiles, cfg.pix), generator=g).to(dev) * got[1]
    args = (cfg, astart, astop, attr, d_color, r0, got[1], k_last)
    valid = attr[pack.VALID_ROW] > 0
    cols = composite_t.composite_backward(*args)
    assert torch.equal(cols[:, valid], composite_t.composite_backward_plain(
        *args)[:, valid])
    rows = composite_t.composite_backward(*args, transposed_out=False)
    assert torch.equal(rows[valid], cols.T[valid])
    cuda_lib.check_guards()


@pytest.mark.parametrize("n,span,empty,offset", [
    (20_000, 3, 0.0, 0), (300, 400, 0.0, 0), (64, 0, 0.0, 0),
    (20_003, 3, 0.0, 1),  # n not a multiple of the warp or of 4; starts
    #                       and counts at an odd address
    (1 << 20, 2, 0.94, 0),  # mostly empty, as at 2^24: all-empty warps
    (4_001, 40, 0.5, 0),  # short and long intervals, half of them empty
    (33, 3000, 0.0, 3),  # only long ones, past 2,597 slots
])
def test_interval_sum_kernel_bit_identical(dev, n, span, empty, offset):
    """K6 against its plain version: intervals with gaps, empty ones, and
    long ones."""
    g = torch.Generator(device="cpu").manual_seed(n)
    count = torch.poisson(torch.full((n,), float(span)), generator=g).int()
    count[::5] = 0
    if empty:
        count[torch.rand(n, generator=g) < empty] = 0
    gaps = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    start = (torch.cumsum(count + gaps, 0) - count).int()
    end = int(start[-1] + count[-1]) if n else 0
    rows = torch.randn((end + 7, pack.NUM_ATTR), generator=g)

    def on_card(t):  # `offset` elements into a buffer: an unaligned start
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
        buf[offset:] = t.to(dev)
        return buf[offset:]

    args = (rows.to(dev), on_card(start), on_card(count), end, n)
    got = segreduce.segment_reduce(*args)
    assert torch.equal(got, segreduce.segment_reduce_plain(*args[:3], n))
    cuda_lib.check_guards()
    ref = torch.zeros((pack.NUM_ATTR, n), dtype=torch.float64)
    seg = torch.repeat_interleave(torch.arange(n), count.long())
    slots = torch.cat([torch.arange(s, s + c) for s, c in
                       zip(start.tolist(), count.tolist())] or [torch.zeros(0)])
    ref.index_add_(1, seg, rows[slots.long()].T.double())
    np.testing.assert_allclose(np_(got), ref.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", [(16, 1.0), (32, 0.5), (16, 1.5),
                                  *EXPAND_EDGES])
def test_expand_carry_kernel_bit_identical(dev, case):
    """K1b: the expand kernel in carry mode against its plain version, on
    frames at tiles of 16 and 32 (tile, capacity fraction) and the kernel's
    edges; on the frames also binning's carried attr_c against the
    gathered pack."""
    if isinstance(case, str):
        args, atab = EXPAND_EDGES[case](dev)
    else:
        tile, frac = case
        proj = _proj(dev, 192, 128, 6)
        args, atab = _frame_expand(proj, tile, frac)
    got = expand.expand_pairs(*args, atab)
    assert got[3].shape == (expand.ATAB_ROWS, args[2])
    for a, b in zip(got, expand.expand_pairs_plain(*args, atab)):
        assert torch.equal(a, b)
    if isinstance(case, str):
        return
    tile, p_out, num_tiles = args[5], args[2], args[3]
    b = TB.bin_gaussians_expand_kernel(proj, 192, 128, tile, tile, p_out,
                                       carry_attrs=True)
    packed = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                     proj.rgb, proj.opac, b.pair_gauss.shape[0])
    real = b.pair_tile < num_tiles
    assert torch.equal(b.attr_c[:, real], packed[:11, real])


def _render_grads(d, p, cam, cfg, c, **kw):
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, d).items()}
    n = p["means"].shape[0]
    out = render(*[tp[k] for k in NAMES], torch.ones(n, dtype=torch.bool, device=d),
                 torch.as_tensor(cam.world_to_camera(), dtype=torch.float32, device=d),
                 torch.as_tensor(cam.intrinsics_array(), device=d), cfg, 3,
                 torch.zeros(3, device=d), **kw)
    gs = torch.autograd.grad((out.color * c.to(d)).sum(), [tp[k] for k in NAMES])
    return out, [np_(x) for x in gs]


@pytest.mark.parametrize("path", ["classic", "scatter", "carry"])
def test_render_paths_on_card_match_sorted(dev, monkeypatch, path):
    """The classic branch (SORTED_SEGRED_MIN raised), the scatter-add
    gradient (need_grads=False) and carry_attrs on the card against the
    default sorted path on the card: the same function summed in another
    order (carry: bit-identical)."""
    from tpugs_torch.ops import composite

    p = synthetic_params_numpy(3000, seed=7)
    cam = orbit_trajectory(p["means"], 4, 160, 96)[3]
    cfg = RasterConfig(img_h=96, img_w=160, tile_h=16, tile_w=16,
                       pair_capacity=1 << 18, max_hits_per_tile=4096)
    c = torch.randn((96, 160, 3), generator=torch.Generator().manual_seed(1))
    _, base = _render_grads(dev, p, cam, cfg, c)
    kw = {"scatter": {"need_grads": False}, "carry": {"carry_attrs": True}}
    if path == "classic":
        monkeypatch.setattr(composite, "SORTED_SEGRED_MIN", 1 << 62)
    before = (composite_t.composite_backward.launches_entry_major,
              segreduce.segment_reduce.launches, expand.expand_pairs.launches_carry)
    _, other = _render_grads(dev, p, cam, cfg, c, **kw.get(path, {}))
    after = (composite_t.composite_backward.launches_entry_major,
             segreduce.segment_reduce.launches, expand.expand_pairs.launches_carry)
    ran = [a - b for a, b in zip(after, before)]
    assert ran == {"classic": [1, 1, 0], "scatter": [1, 0, 0],
                   "carry": [0, 0, 1]}[path]
    for name, a, b in zip(NAMES, other, base):
        assert np.isfinite(a).all(), name
        if path == "carry":
            np.testing.assert_array_equal(a, b, err_msg=name)
        scale = np.abs(b).max()
        close = np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-4 * scale
        assert close.mean() >= 0.999, (name, close.mean())


def _densify_inputs(dev, nc=4096, seed=3):
    """A capacity-padded state: scales around the clone/split boundary,
    opacities around the prune and dead thresholds, average gradients
    around 2e-4 and radii around 20."""
    from tpugs_torch.optim.densify_adc import ADCState

    rng = np.random.default_rng(seed)
    count = rng.integers(0, 6, nc).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    p = {"means": t(rng.normal(size=(nc, 3))),
         "quats": t(rng.normal(size=(nc, 4))),
         "log_scales": t(np.log(rng.uniform(0.002, 0.03, (nc, 3)))),
         "opacity_logits": t(rng.uniform(-7.0, 3.0, nc)),
         "sh": t(rng.normal(size=(nc, 3, 4)))}
    adc = ADCState(grad_accum=t(rng.uniform(0, 6e-4, nc) * count),
                   grad_count=t(count), max_radii=t(rng.uniform(0, 30, nc)))
    alive = torch.from_numpy(rng.uniform(size=nc) < 0.6).to(dev)
    return p, alive, adc


def _assert_event_equal(got, ref, copied, rtol=1e-6):
    """Masks and stats identical, copied rows bit-identical, the rest
    within rtol (exp and log round differently on the card)."""
    params, *masks, stats = got
    rparams, *rmasks, rstats = ref
    for a, b in zip(masks, rmasks):
        assert torch.equal(a.cpu(), b)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in rstats.items()}
    for k in NAMES:
        if k in copied:
            assert torch.equal(params[k].cpu(), rparams[k]), k
        else:
            torch.testing.assert_close(params[k].cpu(), rparams[k], rtol=rtol,
                                       atol=1e-6)


@pytest.mark.parametrize("pruning", [False, True])
def test_densify_on_card_matches_cpu(dev, pruning):
    """adc_densify on the card and on the CPU with the same noise: the
    scatters' duplicate (dropped) rows cannot reach a kept slot."""
    from tpugs_torch.optim.densify_adc import ADCConfig, adc_densify

    gen = torch.Generator().manual_seed(0)
    n1, n2 = torch.randn((2, 4096, 3), generator=gen)
    out = []
    for d in (dev, torch.device("cpu")):
        p, alive, adc = _densify_inputs(d)
        params, alive2, changed, _, stats = adc_densify(
            ADCConfig(), p, alive, adc, 2.0, pruning, noise1=n1.to(d),
            noise2=n2.to(d))
        out.append((params, alive2, changed, stats))
    assert int(out[1][3]["num_cloned"]) > 0
    assert int(out[1][3]["num_split"]) > 0
    _assert_event_equal(out[0], out[1],
                        ("quats", "sh", "opacity_logits"))


@pytest.mark.parametrize("exact", [True, False])
def test_relocate_and_grow_on_card_match_cpu(dev, exact):
    from tpugs_torch.optim.densify_mcmc import MCMCConfig, grow, relocate

    cfg = MCMCConfig(exact_relocation=exact)
    gen = torch.Generator().manual_seed(1)
    u = torch.rand((2, 4096), generator=gen)
    jit = torch.randn((2, 4096, 3), generator=gen)
    out = []
    for d in (dev, torch.device("cpu")):
        p, alive, _ = _densify_inputs(d, seed=4)
        params, changed, stats = relocate(cfg, p, alive, 2.0, u=u[0].to(d),
                                          jitter=jit[0].to(d))
        params, alive2, grown, n_new = grow(cfg, params, alive, 2.0,
                                            u=u[1].to(d), jitter=jit[1].to(d))
        out.append((params, changed, alive2, grown,
                    dict(stats, num_added=n_new)))
    assert int(out[1][4]["num_relocated"]) > 0
    assert int(out[1][4]["num_added"]) > 0
    _assert_event_equal(out[0], out[1],
                        ("quats", "sh") + (("means",) if exact else ()),
                        rtol=2e-5)


def test_trainer_evaluate_on_card_matches_cpu(dev, tmp_path):
    """Trainer.evaluate (render without gradients through K1-K3) on the
    card and on the CPU, after the same 6 ADC steps (no event yet: its
    noise would come from each device's generator)."""
    from tpugs_torch.optim.densify_adc import ADCConfig
    from tpugs_torch.train.trainer import TrainConfig, Trainer
    from tpugs_torch.utils.gt_scene import make_gt_model, write_gt_dataset

    root = str(tmp_path / "s")
    write_gt_dataset(root, make_gt_model(2000, seed=0, device=dev),
                     num_views=10, width=96, height=64, sparse_points=300)
    res = []
    for d in (dev, torch.device("cpu")):
        cfg = TrainConfig(iterations=12, capacity=1024, sh_degree=1,
                          log_every=6, save_every=0, pair_capacity=1 << 15,
                          max_hits_per_tile=256,
                          output_dir=str(tmp_path / str(len(res))),
                          adc=ADCConfig(densify_from=6, densify_every=6))
        assert cfg.densify_mode == "adc"
        tr = Trainer(root, cfg, log_fn=lambda *_: None, device=d)
        tr.train(6)
        res.append(tr.evaluate())
    a, b = res
    assert a.num_gaussians == b.num_gaussians == 300
    assert len(a.images) == 2 and 5.0 < b.mean_psnr < 100.0
    assert abs(a.mean_psnr - b.mean_psnr) <= 1e-2
    assert abs(a.mean_ssim - b.mean_ssim) <= 1e-4


@pytest.mark.parametrize("mode", ["adc", "mcmc"])
def test_graphed_multi_step_equals_eager_steps(dev, mode):
    """make_train_multi_step on the card (the step captured as a CUDA graph
    after two eager steps, then replayed) against make_train_step called
    step by step from the same state: two blocks, losses and every tensor
    of the state bit-equal; MCMC's noise drawn alike."""
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import (TrainConfig, TrainState,
                                           initial_key, make_train_multi_step,
                                           make_train_step)

    w, h, n, k = 192, 128, 2000, 5
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                       pair_capacity=1 << 16, max_hits_per_tile=2048)
    p = params_from_numpy(synthetic_params_numpy(n, seed=1), dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    state = TrainState(params=p, alive=alive, adam=adam_init(p),
                       adc=adc_init(n, dev), key=initial_key(7))
    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.random((3, h, w, 3), dtype=np.float32)).to(dev)
    vms = torch.eye(4, device=dev).expand(3, 4, 4).contiguous()
    intr = torch.as_tensor(synthetic_intrinsics_numpy(w, h),
                           device=dev).expand(3, 4).contiguous()
    tcfg = TrainConfig(densify_mode=mode)
    multi = make_train_multi_step(tcfg, cfg, 1.0)
    step = make_train_step(tcfg, cfg, 1.0)
    ref = state
    for block in range(2):
        vi = rng.integers(0, 3, k)
        state, losses, _ = multi(state, bank, vms, intr, vi, block * k, 3)
        for j, v in enumerate(vi):
            ref, st = step(ref, bank[v], vms[v], intr[v],
                           torch.full((), float(block * k + j), device=dev), 3)
            assert torch.equal(losses[j], st.loss), (block, j)
    for name in NAMES:
        assert torch.equal(state.params[name], ref.params[name]), name
        assert torch.equal(state.adam.v[name], ref.adam.v[name]), name
    assert torch.equal(state.adc.grad_accum, ref.adc.grad_accum)
    runner = multi.graphed[dev].runner
    assert runner.captures == 1 and runner.replays == 2 * k - 2


@pytest.mark.parametrize("mode", ["adc", "mcmc"])
def test_graphed_dist_multi_step_equals_eager_steps(dev, mode):
    """make_dist_multi_step on a 1x1 mesh without a process group (every
    collective the identity, so the block is captured) against
    make_dist_train_step called step by step from the same state: two
    blocks, losses, the mesh statistics and every tensor of the state
    bit-equal; MCMC's noise drawn alike from the shard's seed."""
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.parallel.dist_train import (make_dist_multi_step,
                                                 make_dist_train_step)
    from tpugs_torch.parallel.mesh import make_mesh
    from tpugs_torch.train.trainer import TrainConfig, TrainState, initial_key

    w, h, n, k = 192, 128, 2000, 5
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                       pair_capacity=1 << 16, max_hits_per_tile=2048)
    mesh = make_mesh((1, 1), device=dev)
    p = params_from_numpy(synthetic_params_numpy(n, seed=1), dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    state = TrainState(params=p, alive=alive, adam=adam_init(p),
                       adc=adc_init(n, dev), key=initial_key(7))
    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.random((3, h, w, 3), dtype=np.float32)).to(dev)
    vms = torch.eye(4, device=dev).expand(3, 4, 4).contiguous()
    intr = torch.as_tensor(synthetic_intrinsics_numpy(w, h),
                           device=dev).expand(3, 4).contiguous()
    tcfg = TrainConfig(densify_mode=mode, dist_send_capacity=n)
    multi = make_dist_multi_step(tcfg, cfg, mesh, 1.0)
    step = make_dist_train_step(tcfg, cfg, mesh, 1.0)
    ref = state
    for block in range(2):
        vi = rng.integers(0, 3, k)
        state, losses, stats = multi(state, bank, vms, intr, vi, block * k, 3)
        for j, v in enumerate(vi):
            ref, st = step(ref, bank[v], vms[v], intr[v],
                           torch.full((), float(block * k + j), device=dev), 3)
            assert torch.equal(losses[j], st.loss), (block, j)
        for f in ("num_pairs", "max_local_pairs", "max_send_count",
                  "send_overflow", "max_tile_hits"):
            assert torch.equal(getattr(stats, f), getattr(st, f)), f
    for name in NAMES:
        assert torch.equal(state.params[name], ref.params[name]), name
        assert torch.equal(state.adam.v[name], ref.adam.v[name]), name
    assert torch.equal(state.adc.grad_accum, ref.adc.grad_accum)
    runner = multi.graphed[dev].runner
    assert runner.captures == 1 and runner.replays == 2 * k - 2


def test_blocks_shorter_than_the_warm_up_capture(dev):
    """Blocks of one step (a Trainer whose schedule makes K = 1): the first
    two run eagerly as the key's warm-up, the third captures and replays,
    and every later one replays."""
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import (TrainConfig, TrainState,
                                           initial_key, make_train_multi_step,
                                           make_train_step)

    w, h, n = 96, 64, 500
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                       pair_capacity=1 << 15, max_hits_per_tile=1024)
    p = params_from_numpy(synthetic_params_numpy(n, seed=2), dev)
    state = TrainState(params=p, alive=torch.ones(n, dtype=torch.bool,
                                                  device=dev),
                       adam=adam_init(p), adc=adc_init(n, dev),
                       key=initial_key(3))
    target = torch.rand((1, h, w, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    vm = torch.eye(4, device=dev)[None]
    intr = torch.as_tensor(synthetic_intrinsics_numpy(w, h), device=dev)[None]
    tcfg = TrainConfig(densify_mode="adc")
    multi = make_train_multi_step(tcfg, cfg, 1.0)
    step = make_train_step(tcfg, cfg, 1.0)
    ref = state
    for i in range(5):
        state, losses, _ = multi(state, target, vm, intr, [0], i, 1)
        ref, st = step(ref, target[0], vm[0], intr[0],
                       torch.full((), float(i), device=dev), 1)
        assert torch.equal(losses[0], st.loss), i
    runner = multi.graphed[dev].runner
    assert runner.captures == 1 and runner.replays == 3
    for name in NAMES:
        assert torch.equal(state.params[name], ref.params[name]), name

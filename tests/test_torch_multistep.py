"""The port's block of K train steps (trainer.make_train_multi_step) and
what lets it run as one captured CUDA graph on the card, on the CPU:

- make_train_multi_step against tpugs' make_train_multi_step (K steps in
  one jitted lax.scan) from the same state, views and schedule step, with
  densify_mode "none" and "adc": losses within rtol 1e-4, parameters by
  the Trainer rule (steps x 2 x the group's lr on >= 99.9% of elements, as
  Adam's eps 1e-15 turns an ulp of a near-zero gradient into a full-lr
  step), the ADC counts and radii identical, the accumulated gradient
  norms within ADC_RTOL (the JAX side composites with its scan here,
  another summation order), the Adam count; and the K steps are K calls
  of the port's make_train_step, bit for bit;
- the binning at its static size (the pair capacity) against tpugs'
  bin_gaussians: the segments and the sorted real pairs bit-exact with the
  exact presort and the 2-key sort, with and without reduce_meta, the
  total past the capacity included; every slot past the real pairs holds
  the sentinel tile;
- binning's wrapper, the pack, combined_loss, adam_step, position_lr and
  adc_accumulate read nothing to the host: Tensor.item, __bool__,
  __int__, __float__, __index__ and tolist raise while they run (the plain
  versions of the kernels, which read by design, are not among them).
tests/test_torch_bench.py holds the port's bench run_k, whose card path is
the same mechanism.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_parity import (assert_segments_equal, jax_projection, np_,
                                random_projection, torch_projection)
from tpugs.ops import binning as JB
from tpugs.train import trainer as JT
from tpugs_torch.core.gaussians import train_state_from_numpy
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import pack as TP
from tpugs_torch.optim import adam as TA
from tpugs_torch.optim import densify_adc as TADC
from tpugs_torch.optim import lr_schedule as TL
from tpugs_torch.train import loss as TLoss
from tpugs_torch.train import trainer as TT

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
MIN_CLOSE = 0.999
# Accumulated screen-gradient norms: the JAX side's scan compositor adds in
# another order (2.8e-7 measured).
ADC_RTOL = 1e-5
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
VIEWS = np.asarray([2, 0, 3, 1])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "s")
    make_scene(root, num_images=6, width=64, height=48, num_points=60)
    return root


def _cfgs(mode, out):
    kw = dict(iterations=8, capacity=128, sh_degree=1, log_every=1,
              save_every=0, densify_mode=mode, pair_capacity=1 << 14,
              max_hits_per_tile=128, output_dir=out)
    return TT.TrainConfig(**kw), JT.TrainConfig(**kw)


def _flat(jstate) -> dict:
    """tpugs' TrainState as the port's checkpoint-named numpy leaves."""
    n = np.asarray
    flat = {f"params/{k}": n(v) for k, v in jstate.params.items()}
    flat.update({f"adam_m/{k}": n(v) for k, v in jstate.adam.m.items()})
    flat.update({f"adam_v/{k}": n(v) for k, v in jstate.adam.v.items()})
    flat.update(alive=n(jstate.alive), adam_count=n(jstate.adam.count),
                adc_grad_accum=n(jstate.adc.grad_accum),
                adc_grad_count=n(jstate.adc.grad_count),
                adc_max_radii=n(jstate.adc.max_radii),
                key=TT.initial_key(42))
    return flat


@pytest.mark.parametrize("mode", ["none", "adc"])
def test_multi_step_matches_jax(scene, tmp_path, mode):
    """K = 4 steps from one state through both multi-steps."""
    tcfg, jcfg = _cfgs(mode, str(tmp_path))
    tr = TT.Trainer(scene, tcfg, log_fn=lambda *_: None, device="cpu")
    jt = JT.Trainer(scene, jcfg, log_fn=lambda *_: None)
    assert tr.raster == type(tr.raster)(**vars(jt.raster))
    # A state some steps in: the JAX Trainer's, trained 3 steps, with
    # nonzero moments and accumulators.
    jt.train(3)
    flat = _flat(jt.state)
    state = train_state_from_numpy(flat, "cpu")
    jms = JT.make_train_multi_step(jcfg, jt.raster, jt.scene_extent)
    tms = TT.make_train_multi_step(tcfg, tr.raster, tr.scene_extent)
    step0, deg = 3, 1
    jstate, jlosses, jstats = jms(
        jt.state, jt._image_bank(), jt._viewmats, jt._intrinsics,
        jnp.asarray(VIEWS, jnp.int32), jnp.asarray(step0, jnp.float32), deg)
    tstate, tlosses, tstats = tms(state, tr._image_bank(), tr._viewmats,
                                  tr._intrinsics, VIEWS, step0, deg)
    k = VIEWS.shape[0]
    np.testing.assert_allclose(np_(tlosses), np.asarray(jlosses),
                               rtol=LOSS_RTOL)
    lrs = {key: float(v) for key, v in
           TA.group_lrs(TA.AdamConfig(), float(step0)).items()}
    for name in NAMES:
        a, b = np_(tstate.params[name]), np.asarray(jstate.params[name])
        assert np.isfinite(a).all()
        close = np.abs(a - b) <= k * 2 * lrs[name] + 1e-6
        assert close.mean() >= MIN_CLOSE, (name, close.mean())
    assert int(tstate.adam.count) == int(jstate.adam.count) == 3 + k
    np.testing.assert_array_equal(np_(tstate.alive), np.asarray(jstate.alive))
    np.testing.assert_array_equal(tstate.key, TT.initial_key(42) + [0, k])
    assert int(tstats.num_pairs) == int(jstats.num_pairs)
    assert int(tstats.max_tile_hits) == int(jstats.max_tile_hits)
    assert not bool(tstats.pair_overflow) and not bool(tstats.hit_overflow)
    np.testing.assert_allclose(float(tstats.loss), float(jlosses[-1]),
                               rtol=LOSS_RTOL)
    got, ref = tstate.adc, jstate.adc
    if mode == "none":  # passed through untouched
        assert not np_(got.grad_count).any()
        return
    np.testing.assert_array_equal(np_(got.grad_count),
                                  np.asarray(ref.grad_count))
    np.testing.assert_array_equal(np_(got.max_radii), np.asarray(ref.max_radii))
    assert np_(got.grad_count).max() == 3 + k
    np.testing.assert_allclose(np_(got.grad_accum), np.asarray(ref.grad_accum),
                               rtol=ADC_RTOL, atol=1e-9)


def test_multi_step_is_the_single_steps(scene, tmp_path):
    """The multi-step's K steps are K calls of make_train_step with the key
    and the schedule step advanced, bit for bit (on the CPU both are the
    eager steps; on the card chip_smoke.py holds the graph to them)."""
    tcfg, _ = _cfgs("adc", str(tmp_path))
    tr = TT.Trainer(scene, tcfg, log_fn=lambda *_: None, device="cpu")
    images = tr._image_bank()
    state, losses, stats = TT.make_train_multi_step(
        tcfg, tr.raster, tr.scene_extent)(tr.state, images, tr._viewmats,
                                          tr._intrinsics, VIEWS, 0, 0)
    step = TT.make_train_step(tcfg, tr.raster, tr.scene_extent)
    ref = tr.state
    for j, v in enumerate(VIEWS):
        ref, s = step(ref, images[v], tr._viewmats[v], tr._intrinsics[v],
                      torch.tensor(float(j)), 0)
        assert torch.equal(losses[j], s.loss)
    for name in NAMES:
        assert torch.equal(state.params[name], ref.params[name])
    assert torch.equal(state.adc.grad_accum, ref.adc.grad_accum)
    np.testing.assert_array_equal(state.key, ref.key)


SHAPES = [(64, 48, 16), (96, 64, 32)]


def _nt(w, h, tile):
    return (-(-w // tile)) * (-(-h // tile))


@pytest.mark.parametrize("w,h,tile", SHAPES)
@pytest.mark.parametrize("presorted", [True, False])
@pytest.mark.parametrize("cap_frac", [1.7, 0.5])
@pytest.mark.parametrize("reduce_meta", [False, True])
def test_static_binning_matches_jax(w, h, tile, presorted, cap_frac,
                                    reduce_meta):
    """bin_gaussians_expand_kernel at the static size against tpugs'
    bin_gaussians (whose sizes are static too); cap_frac 0.5 puts the total
    past the capacity."""
    d = random_projection(300, w, h, 2, big_rects=True)
    tp, jp = torch_projection(d), jax_projection(d)
    if presorted:
        tp, jp = TB.presort_by_depth(tp)[1], JB.presort_by_depth(jp)[1]
    total = int(TB.expand_inputs(tp, w, h, tile, tile, 1 << 20).total)
    cap = int(total * cap_frac)
    nt = _nt(w, h, tile)
    got = TB.bin_gaussians_expand_kernel(tp, w, h, tile, tile, cap,
                                         presorted=presorted,
                                         reduce_meta=reduce_meta)
    ref = JB.bin_gaussians(jp, w, h, tile, tile, cap, presorted=presorted)
    assert got.pair_gauss.shape == got.pair_tile.shape == (cap,)
    assert_segments_equal(ref, got, nt)
    assert bool(got.overflow) == (cap < total) == bool(ref.overflow)
    assert int(got.num_pairs) == total
    tile_t, ref_tile = np_(got.pair_tile), np.asarray(ref.pair_tile)
    real = int((tile_t < nt).sum())
    assert real == int((ref_tile < nt).sum()) > 0
    assert (tile_t[real:] == nt).all() and (tile_t[:real] < nt).all()
    np.testing.assert_array_equal(tile_t[:real], ref_tile[:real])
    np.testing.assert_array_equal(np_(got.pair_gauss)[:real],
                                  np.asarray(ref.pair_gauss)[:real])
    if reduce_meta:
        assert got.exp_end == cap
        slot = np_(got.exp_slot)
        np.testing.assert_array_equal(np.sort(slot), np.arange(cap))
        owned = slot < min(total, cap)
        g = np_(got.pair_gauss)[owned]
        np.testing.assert_array_equal(np.bincount(g, minlength=300),
                                      np_(got.red_count))
        start, count = np_(got.red_start), np_(got.red_count)
        assert (start[1:] >= start[:-1] + count[:-1]).all()
        assert start[-1] + count[-1] <= min(total, cap)


READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist")


@contextlib.contextmanager
def no_host_reads():
    """Tensor.item, __bool__, __int__, __float__, __index__ and tolist
    raise while the block runs."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(*_a, **_k):
            raise AssertionError(f"a host read: Tensor.{name}")
        return read

    for name in READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_no_host_reads_guard_works():
    with no_host_reads():
        for read in (lambda t: t.item(), bool, int, float,
                     lambda t: t.tolist(), lambda t: [0, 1][t]):
            with pytest.raises(AssertionError, match="a host read"):
                read(torch.tensor(1))
    assert int(torch.tensor(3)) == 3


@pytest.mark.parametrize("presorted,qbits,carry,meta", [
    (True, 0, False, False), (False, 0, False, True), (False, 32, True, False),
    (True, 0, True, True)])
def test_binning_and_pack_read_nothing_to_the_host(presorted, qbits, carry,
                                                   meta):
    w, h, tile = 96, 64, 16
    tp = torch_projection(random_projection(300, w, h, 3, big_rects=True))
    if presorted:
        tp = TB.presort_by_depth(tp)[1]
    with no_host_reads():
        b = TB.bin_gaussians_expand_kernel(
            tp, w, h, tile, tile, 4096, presorted=presorted,
            quant_key_bits=qbits, reduce_meta=meta, carry_attrs=carry)
        b, hits = TB.clamp_tile_segments(b, 64)
        astart, astop, counts = TP.aligned_offsets(b.tile_start, b.tile_stop)
        attr_c = TP.pack_compact_attrs(b.pair_gauss, tp.means2d, tp.conic,
                                       tp.rgb, tp.opac, b.pair_gauss.shape[0])
        p_al = TP.p_aligned_chunked(b.pair_gauss.shape[0], _nt(w, h, tile))
        attr = TP.align_copy(attr_c, b.tile_start, astart, counts, p_al)
    assert attr.shape == (TP.ATTR_ROWS, p_al)
    assert int(TP.aligned_length(astart, counts)) <= p_al
    assert int(b.num_pairs) == int(TB.expand_inputs(tp, w, h, tile, tile,
                                                    4096).total)


def test_loss_adam_lr_and_adc_read_nothing_to_the_host():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((48, 64, 3), dtype=np.float32))
    tgt = torch.from_numpy(rng.random((48, 64, 3), dtype=np.float32))
    params = {k: torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
              for k in NAMES}
    grads = {k: torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
             for k in NAMES}
    adc = TADC.adc_init(40, "cpu")
    d2 = torch.from_numpy(rng.normal(size=(40, 2)).astype(np.float32))
    radii = torch.from_numpy(rng.integers(0, 3, 40).astype(np.int32))
    step = torch.tensor(5.0)
    with no_host_reads():
        loss = TLoss.combined_loss(img, tgt, 0.2)
        new, st = TA.adam_step(TA.AdamConfig(), TA.adam_init(params), params,
                               grads, step)
        lr = TL.position_lr(step, TL.PositionLRConfig())
        adc = TADC.adc_accumulate(adc, d2, radii, torch.tensor([32.0, 24.0]))
    assert torch.isfinite(loss) and int(st.count) == 1
    assert float(lr) < 1.6e-4 and float(adc.grad_count.sum()) > 0


class _EagerRunner(TT.graph.BlockRunner):
    """graph.BlockRunner with every replay replaced by an eager call of the
    captured body: the card path's bookkeeping (static buffers, staged
    rows, the step counter, generator re-seeding) on the CPU."""

    def __init__(self, device, width, generators=()):
        self.device, self.width = device, width
        self.generators = tuple(generators)
        self.graphs, self.rows, self.losses = {}, None, None
        self.counter = torch.zeros((1,), dtype=torch.int64)
        self.captures = self.replays = 0
        self.capture_seconds = []

    def stage(self, rows):
        k = rows.shape[0]
        if self.rows is None or self.rows.shape[0] < k:
            self.rows = torch.zeros((max(k, 32), self.width))
            self.losses = torch.zeros((max(k, 32),))
            self.release()
        self.rows[:k] = torch.from_numpy(np.asarray(rows, np.float32))
        self.counter.zero_()

    def run(self, key, k, body, before_step=None):
        if key not in self.graphs:
            self.graphs[key] = body
            self.captures += 1
        for j in range(k):
            if before_step is not None:
                before_step(j)
            self.graphs[key]()
        self.replays += k
        return 0


@pytest.mark.parametrize("mode", ["adc", "mcmc", "none"])
def test_graphed_bookkeeping_is_the_eager_steps(scene, tmp_path, monkeypatch,
                                                mode):
    """make_train_multi_step's card path run on the CPU with its replays
    made eager calls of the captured body: two blocks (the second from the
    first's buffers, an event's new tensors copied in between) are the
    eager multi-step's, bit for bit; MCMC's noise comes from the re-seeded
    generator."""
    monkeypatch.setattr(TT.graph, "BlockRunner", _EagerRunner)
    tcfg, _ = _cfgs(mode, str(tmp_path))
    tr = TT.Trainer(scene, tcfg, log_fn=lambda *_: None, device="cpu")
    bank = (tr._image_bank(), tr._viewmats, tr._intrinsics)
    graphed = TT._GraphedSteps(tcfg, tr.raster, torch.device("cpu"))
    eager = TT.make_train_multi_step(tcfg, tr.raster, tr.scene_extent)
    s_g, l_g, st_g = graphed(tr.state, *bank, VIEWS, 0, 1)
    s_e, l_e, st_e = eager(tr.state, *bank, VIEWS, 0, 1)
    assert torch.equal(l_g, l_e) and torch.equal(st_g.l1, st_e.l1)
    # An event between the blocks: new tensors for one group.
    s_g = TT.reset_opacity_step(s_g)
    s_e = TT.reset_opacity_step(s_e)
    ptr = s_g.params["means"].data_ptr()
    s_g, l_g, _ = graphed(s_g, *bank, VIEWS[::-1], 4, 1)
    s_e, l_e, _ = eager(s_e, *bank, VIEWS[::-1], 4, 1)
    assert s_g.params["means"].data_ptr() == ptr  # the static buffer
    assert torch.equal(l_g, l_e)
    for name in NAMES:
        assert torch.equal(s_g.params[name], s_e.params[name]), name
        assert torch.equal(s_g.adam.m[name], s_e.adam.m[name]), name
    assert torch.equal(s_g.adc.grad_accum, s_e.adc.grad_accum)
    assert int(s_g.adam.count) == 8
    np.testing.assert_array_equal(s_g.key, s_e.key)
    assert graphed.runner.captures == 1 and graphed.runner.replays == 8


def test_bench_graphed_bookkeeping_is_run_k(monkeypatch):
    """The port's bench: run_k's card path (static params and Adam buffers,
    the staged schedule steps) on the CPU with eager replays equals run_k's
    eager loop over two rounds, bit for bit."""
    from tpugs_torch import bench
    from tpugs_torch.ops.render import RasterConfig

    monkeypatch.setattr(TT.graph, "BlockRunner", _EagerRunner)
    w, h = 96, 64
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=32, tile_w=32,
                       pair_capacity=1 << 14, max_hits_per_tile=512)
    params, alive, vm, intr, bg = bench.bench_scene(w, h, 300)
    step = bench.make_bench_step(cfg, alive, vm, intr, bg,
                                 bench.bench_target(w, h))
    graphed = bench._GraphedSteps(step, torch.device("cpu"))
    p_g, a_g, p_e, a_e = params, TA.adam_init(params), params, \
        TA.adam_init(params)
    for r in range(2):
        p_g, a_g, l_g = graphed(p_g, a_g, float(3 * r), 3)
        p_e, a_e, l_e = bench.run_k(step, p_e, a_e, float(3 * r), 3)
        assert torch.equal(l_g, l_e)
    for name in NAMES:
        assert torch.equal(p_g[name], p_e[name]) and torch.equal(
            a_g.v[name], a_e.v[name]), name
    assert int(a_g.count) == 6 and graphed.runner.replays == 6

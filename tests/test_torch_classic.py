"""The classic segment-reduction backward against tpugs on the same numpy
inputs: the entry-major backward compositor's plain version against tpugs'
Pallas backward kernel (transposed_out=False, interpret mode) and against
the port's own attribute-major version, the interval segment sum's plain
version against tpugs' segment-reduce kernel (interpret mode), binning's
reduce_meta, and render()'s gradients on the classic path (both packages'
thresholds raised) against jax.grad of tpugs' render(compositor="pallas").

Tolerances, with their reasons:
- entry-major backward rows against tpugs' kernel: as for the
  attribute-major rows (tests/test_torch_backward.py), rtol 1e-4 with atol
  1e-5 x the row's largest magnitude; against the port's attribute-major
  rows: bit-identical (one kernel, one summation tree).
- interval sums: atol 1e-6 x each row's largest magnitude. The port adds an
  interval slot by slot; tpugs sums it in a one-hot matmul. The one
  interval of 2,597 slots gets 1e-5, as tpugs' own test of it
  (tests/test_segreduce.py): a sequential f32 sum drifts as the square root
  of its length (measured 4.7e-6 of a row's largest magnitude; tpugs'
  matmul sum stays within 1e-7 of an exact float64 sum).
- render() gradients: rtol 1e-4 (as tests/test_torch_backward.py's) with
  atol 3e-6 x the array's largest magnitude, on every element: projection's ulps carried through
  the chain rule, and the summation order of the pair -> gaussian sums
  (measured at most 4e-6 of the largest magnitude without the rtol).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backward import (_aligned_scene, _assert_rows_close,
                                       _cotangents, _model, _written)
from tests.torch_parity import (np_, random_projection, render_grads_both,
                                torch_projection)
from tpugs.ops import rasterize_tiled as JR
from tpugs.ops.binning import bin_gaussians_expand_kernel as jax_bin
from tpugs.ops.pallas import composite as JC
from tpugs.ops.pallas.composite_t import composite_backward_pallas
from tpugs.ops.pallas.segreduce import C as J_CHUNK
from tpugs.ops.pallas.segreduce import IN_LANES, segment_reduce_pallas
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite as TCOMP
from tpugs_torch.ops import composite_t as TC
from tpugs_torch.ops import pack as TP
from tpugs_torch.ops import segreduce as TS

torch.set_num_threads(1)

CAP = 8192
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 3e-6
SEG_ATOL_REL = 1e-6
RAISED = 1 << 62  # a SORTED_SEGRED_MIN that no aligned capacity reaches


@pytest.mark.parametrize("w,h,tile,seed", [(64, 48, 16, 0), (96, 64, 32, 1)])
def test_entry_major_backward_matches_pallas_and_transposed(w, h, tile, seed):
    cfg, astart, astop, attr = _aligned_scene(w, h, tile, seed)
    _, final_t, _, k_last = TC.composite_forward(cfg, astart, astop, attr)
    d_color, r0_scale = _cotangents(cfg, seed)
    args = (cfg, astart, astop, attr, d_color, r0_scale * final_t, final_t,
            k_last)
    rows = np_(TC.composite_backward(*args, transposed_out=False))
    p_al = attr.shape[1]
    assert rows.shape == (p_al, TP.NUM_ATTR)
    np.testing.assert_array_equal(rows, np_(TC.composite_backward(*args)).T)
    attr_j = jnp.asarray(np.pad(np_(attr), ((0, 0), (0, 1024))))
    jcfg = JR.RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=CAP, max_hits_per_tile=512)
    ref = np.asarray(composite_backward_pallas(
        jcfg, *[jnp.asarray(np_(a)) for a in (astart, astop)], attr_j,
        *[jnp.asarray(np_(a)) for a in args[4:]], interpret=True,
        transposed_out=False))
    m = _written(astart, astop, p_al)
    _assert_rows_close(rows[m].T, ref[:p_al, :TP.NUM_ATTR][m].T)
    assert np.isfinite(rows[m]).all() and np.abs(rows[m]).max() > 0


def _intervals(seed, n, avg_span, gap_every=7, empty_every=5):
    """Monotone, disjoint intervals with unowned gaps and empty ones, as
    tests/test_segreduce.py draws them."""
    rng = np.random.default_rng(seed)
    start = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    pos = 0
    for g in range(n):
        if empty_every and g % empty_every == 0:
            start[g] = pos
            continue
        if gap_every and g % gap_every == 0:
            pos += int(rng.integers(1, 9))
        c = max(1, int(rng.poisson(avg_span)))
        start[g], count[g] = pos, c
        pos += c
    return start, count, pos


def _huge(seed):
    """One interval over many of the reference's chunks, the rest empty."""
    n, span = 130, 5 * J_CHUNK + 37
    start = np.full(n, 11 + span, np.int32)
    count = np.zeros(n, np.int32)
    start[:2] = 11
    count[1] = span
    return start, count, 11 + span


@pytest.mark.parametrize("case", ["short", "two", "long", "huge", "empty",
                                  "odd_n"])
def test_interval_sum_matches_pallas_kernel(case):
    if case == "huge":
        start, count, end = _huge(3)
    elif case == "empty":
        start, count, end = np.zeros(256, np.int32), np.zeros(256, np.int32), 0
    else:
        # odd_n: n not a multiple of 4 or of a warp, intervals of tens of
        # slots.
        n, span = {"short": (256, 4), "two": (640, 2), "long": (128, 40),
                   "odd_n": (203, 34)}[case]
        start, count, end = _intervals(0, n, span)
    n = start.shape[0]
    p_in = -(-(end + J_CHUNK) // J_CHUNK) * J_CHUNK
    rows = np.random.default_rng(1).normal(
        0, 1, (p_in, IN_LANES)).astype(np.float32)
    got = np_(TS.segment_reduce(torch.from_numpy(rows[:end, :TP.NUM_ATTR].copy()),
                                torch.from_numpy(start), torch.from_numpy(count),
                                end, n))
    ref = np.asarray(segment_reduce_pallas(
        jnp.asarray(rows), jnp.asarray(start), jnp.asarray(count),
        jnp.asarray(end, jnp.int32), interpret=True))[:TP.NUM_ATTR]
    assert got.shape == (TP.NUM_ATTR, n)
    tol = 1e-5 if case == "huge" else SEG_ATOL_REL
    for r in range(TP.NUM_ATTR):
        scale = max(np.abs(ref[r]).max(), 1e-30)
        np.testing.assert_allclose(got[r], ref[r], rtol=0, atol=tol * scale,
                                   err_msg=f"row {r}")
    assert not got[:, count == 0].any()  # empty intervals sum to zero


@pytest.mark.parametrize("length", [3, 40, 100])
def test_interval_sum_plain_adds_in_slot_order(length):
    """segment_reduce_plain adds each interval one slot after another from
    zero, as the kernel's thread does (csrc/segreduce.cu), whatever its
    length; a pairwise or lane-split sum would not match bit for bit on
    these magnitudes."""
    rng = np.random.default_rng(length)
    rows = (rng.normal(0, 1, (3 * length + 5, TP.NUM_ATTR))
            * 10.0 ** rng.uniform(-3, 7, (3 * length + 5, 1))).astype(np.float32)
    start = np.int32([0, length, length + 2, 2 * length + 2])
    count = np.int32([length, 2, 0, length])
    got = np_(TS.segment_reduce_plain(torch.from_numpy(rows),
                                      torch.from_numpy(start),
                                      torch.from_numpy(count), 4))
    for g in range(4):
        acc = np.zeros(TP.NUM_ATTR, np.float32)
        for r in rows[start[g]:start[g] + count[g]]:
            acc = acc + r
        np.testing.assert_array_equal(got[:, g], acc)
    # Interval 0 is ((0 + 1e8) + 1) - 1e8 in f32 = 0: slot order, from zero.
    rows = torch.tensor([[1e8], [1.0], [-1e8], [3.0], [5.0]]).repeat(1, TP.NUM_ATTR)
    got = TS.segment_reduce_plain(rows, torch.tensor([0, 3, 3], dtype=torch.int32),
                                  torch.tensor([3, 0, 2], dtype=torch.int32), 3)
    np.testing.assert_array_equal(np_(got)[0], np.float32([0.0, 0.0, 8.0]))


@pytest.mark.parametrize("sort,cap_frac", [
    ("presorted", 1.0), ("2key", 1.0), ("qkey", 1.0), ("presorted", 0.6),
    ("2key", 0.6),
])
def test_reduce_meta_intervals_hold_each_gaussians_pairs(sort, cap_frac):
    """Every sorted pair's exp_slot lies in its gaussian's interval, each
    interval holds exactly its gaussian's pairs (exp_slot is a permutation
    and the counts agree), the intervals are monotone and disjoint, and the
    counts truncate at the capacity as tpugs' reduce_meta does."""
    w, h, n = 96, 64, 300
    d = random_projection(n, w, h, seed=4, big_rects=True)
    presorted, qbits = sort == "presorted", 32 if sort == "qkey" else 0
    tp = torch_projection(d)
    if presorted:
        tp = TB.presort_by_depth(tp)[1]
    total = TB.expand_inputs(tp, w, h, 16, 16, 1 << 24).total
    cap = int(total * cap_frac)
    b = TB.bin_gaussians_expand_kernel(tp, w, h, 16, 16, cap,
                                       presorted=presorted,
                                       quant_key_bits=qbits, reduce_meta=True)
    p = b.pair_gauss.shape[0]
    assert b.exp_end == p == min(total, cap)
    slot, g = np_(b.exp_slot).astype(np.int64), np_(b.pair_gauss)
    start, count = np_(b.red_start), np_(b.red_count)
    np.testing.assert_array_equal(np.sort(slot), np.arange(p))
    assert ((start[g] <= slot) & (slot < start[g] + count[g])).all()
    np.testing.assert_array_equal(np.bincount(g, minlength=n), count)
    assert (start[1:] >= start[:-1] + count[:-1]).all()
    assert start[-1] + count[-1] <= b.exp_end
    jp = jax_bin(_jproj(d, presorted), w, h, 16, 16, cap,
                 interpret=True, presorted=presorted, reduce_meta=True,
                 quant_key_bits=qbits)
    np.testing.assert_array_equal(np.asarray(jp.red_count)[:n], count)


def _jproj(d, presorted):
    from tests.torch_parity import jax_projection
    from tpugs.ops.binning import presort_by_depth

    jp = jax_projection(d)
    return presort_by_depth(jp)[1] if presorted else jp


def _assert_grads_close(got, ref):
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        assert np.isfinite(g).all(), f"{k}: not finite"
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale, err_msg=k)


def _counting(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls.append(name)
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("seed,presort,max_hits,saturated", [
    (0, "exact", 512, False), (1, False, 512, False), (3, "exact", 24, True),
])
def test_classic_render_gradients_match_jax(monkeypatch, seed, presort,
                                            max_hits, saturated):
    """Both packages' sorted-reduction thresholds raised: the classic
    branch (entry-major rows, the inverted pair sort, the interval sum) in
    each, and in the saturated case tiles clamped to their front 24
    entries."""
    monkeypatch.setattr(TCOMP, "SORTED_SEGRED_MIN", RAISED)
    monkeypatch.setattr(JC, "_SORTED_SEGRED_MIN", RAISED)
    classic = _counting(monkeypatch, TCOMP, "classic_reduce")
    sorted_ = _counting(monkeypatch, TCOMP, "reduce_pair_grads")
    p, vm, intr = _model(64, 48, seed)
    if saturated:
        p["opacity_logits"][:] = np.random.default_rng(seed).uniform(
            4.0, 12.0, p["opacity_logits"].shape).astype(np.float32)
    alive = np.ones(p["means"].shape[0], bool)
    out, jo, got, ref = render_grads_both(p, alive, vm, intr, 64, 48, 16,
                                          presort, cap=CAP, max_hits=max_hits,
                                          seed=seed)
    assert classic and not sorted_
    assert bool(out.hit_overflow) == bool(jo.hit_overflow) == saturated
    np.testing.assert_allclose(np_(out.color), np.asarray(jo.color), atol=1e-5)
    _assert_grads_close(got, ref)
    assert np.abs(got["probe"]).max() > 0 and np.abs(got["sh"]).max() > 0


def test_classic_branch_needs_reduce_meta(monkeypatch):
    from tpugs_torch.ops.rasterize_tiled import RasterConfig

    cfg = RasterConfig(img_h=48, img_w=64, tile_h=16, tile_w=16)
    assert not TCOMP.segred_needs_meta(cfg, 1000)
    assert TCOMP.segred_needs_meta(cfg, 1 << 24)
    assert JC.segred_needs_meta(JR.RasterConfig(img_h=48, img_w=64, tile_h=16,
                                                tile_w=16), 1 << 24)
    monkeypatch.setattr(TCOMP, "SORTED_SEGRED_MIN", RAISED)
    assert TCOMP.segred_needs_meta(cfg, 1000)
    z = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="reduce_meta"):
        TCOMP.CompositeSegred.apply(cfg, z, z, z[:0], torch.zeros(1000, 2),
                                    torch.zeros(1000, 3), torch.zeros(1000, 3),
                                    torch.zeros(1000), torch.zeros(3), 0, None,
                                    None)


def test_gaussians_behind_the_camera_change_nothing(monkeypatch):
    """The large-scene cell at a small size: gaussians padded behind the
    camera (pad_behind_camera) leave the image and the seen gaussians'
    classic-branch gradients bit-identical, and get zero gradients."""
    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops.render import RasterConfig, render
    from tpugs_torch.utils.synthetic import (pad_behind_camera,
                                             synthetic_intrinsics_numpy,
                                             synthetic_params_numpy)

    monkeypatch.setattr(TCOMP, "SORTED_SEGRED_MIN", RAISED)
    names = ("means", "quats", "log_scales", "opacity_logits", "sh")
    base = params_from_numpy(synthetic_params_numpy(200, seed=3), "cpu")
    cfg = RasterConfig(img_h=48, img_w=64, tile_h=16, tile_w=16,
                       pair_capacity=CAP, max_hits_per_tile=512)
    intr = torch.from_numpy(synthetic_intrinsics_numpy(64, 48))
    c_col = torch.from_numpy(np.random.default_rng(4).normal(
        size=(48, 64, 3)).astype(np.float32))
    outs, grads = [], []
    for p in (base, pad_behind_camera(base, 1000)):
        tp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        n = tp["means"].shape[0]
        out = render(*[tp[k] for k in names], torch.ones(n, dtype=torch.bool),
                     torch.eye(4), intr, cfg, 3, torch.zeros(3), presort=False)
        grads.append(torch.autograd.grad((out.color * c_col).sum(),
                                         [tp[k] for k in names]))
        outs.append(out)
    assert not outs[1].visible[200:].any() and outs[0].visible.any()
    assert torch.equal(outs[0].color, outs[1].color)
    for k, a, b in zip(names, *grads):
        assert torch.equal(a, b[:200]), k
        assert not b[200:].any(), k

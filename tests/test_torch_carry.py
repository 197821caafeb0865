"""carry_attrs against tpugs on the same numpy inputs: the expand kernel's
plain version in carry mode against tpugs' expand_pairs_pallas carry
output (interpret mode) on the real pairs, binning's attr_c against the
gathered pack, and render(carry_attrs=True) against carry_attrs=False
(images and gradients bit-identical) and against tpugs'
render(carry_attrs=True) (the forward tolerance of
tests/test_torch_render.py: atol 1e-5 on color and T)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import _assert_outputs_match, _case
from tests.torch_parity import (NAMES, jax_projection, np_, random_projection,
                                torch_projection)
from tpugs.ops.binning import bin_gaussians_expand_kernel as jax_bin
from tpugs.ops.binning import presort_by_depth as jax_presort
from tpugs.ops.pallas import expand as JEX
from tpugs.ops.render import RasterConfig as JaxConfig
from tpugs.ops.render import render as jax_render
from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import expand as EX
from tpugs_torch.ops import pack as TP
from tpugs_torch.ops.render import RasterConfig, render

torch.set_num_threads(1)

W, H, TILE = 96, 64, 16


def _by_pair(tile, gid, *rows):
    """The real pairs' rows ordered by (gid, tile): the two packages lay out
    their expansions differently, but hold the same (gid, tile) pairs."""
    order = np.lexsort((tile, gid))
    return [np.asarray(r)[..., order] for r in (tile, gid) + rows]


@pytest.mark.parametrize("presorted,cap_frac", [(False, 1.0), (True, 1.0),
                                                (False, 0.6)])
def test_expand_carry_matches_pallas_on_pairs(monkeypatch, presorted, cap_frac):
    d = random_projection(300, W, H, seed=6, big_rects=True)
    tp = torch_projection(d)
    jp = jax_projection(d)
    if presorted:
        tp, jp = TB.presort_by_depth(tp)[1], jax_presort(jp)[1]
    total = TB.expand_inputs(tp, W, H, TILE, TILE, 1 << 24).total
    cap = int(total * cap_frac)
    outs = []
    orig = JEX.expand_pairs_pallas

    def recorded(*a, **kw):
        outs.append(np.asarray(orig(*a, **kw)))
        return outs[-1]

    monkeypatch.setattr(JEX, "expand_pairs_pallas", recorded)
    jax_bin(jp, W, H, TILE, TILE, cap, interpret=True, presorted=presorted,
            carry_attrs=True)
    ref = outs[0]
    ex = TB.expand_inputs(tp, W, H, TILE, TILE, cap, presorted)
    atab = TP.gaussian_attrs(tp.means2d, tp.conic, tp.rgb, tp.opac).T.contiguous()
    tile, depth, gid, attrs = (np_(x) for x in EX.expand_pairs(
        ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, TILE, TILE, atab))
    assert attrs.shape == (TP.NUM_ATTR, ex.p_out)
    np.testing.assert_array_equal(attrs, np_(atab)[:, gid])
    real = tile < ex.num_tiles
    jreal = ref[3] > 0
    got = _by_pair(tile[real], gid[real], depth[real], attrs[:, real])
    exp = _by_pair(ref[0, jreal].astype(np.int32), ref[2, jreal].astype(np.int32),
                   ref[1, jreal], ref[4:13, jreal])
    assert got[0].shape[0] > 0 and got[0].shape == exp[0].shape
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sort", ["2key", "presorted", "qkey"])
def test_attr_c_bit_identical_to_pack(sort):
    """In every tile segment attr_c equals the gathered pack; its valid row
    marks exactly the real pairs."""
    tp = torch_projection(random_projection(300, W, H, seed=8))
    presorted = sort == "presorted"
    if presorted:
        tp = TB.presort_by_depth(tp)[1]
    b = TB.bin_gaussians_expand_kernel(
        tp, W, H, TILE, TILE, 8192, presorted=presorted,
        quant_key_bits=32 if sort == "qkey" else 0, carry_attrs=True)
    p = b.pair_gauss.shape[0]
    attr_c = np_(b.attr_c)
    assert attr_c.shape == (11, p)
    packed = np_(TP.pack_compact_attrs(b.pair_gauss, tp.means2d, tp.conic,
                                       tp.rgb, tp.opac, p))[:11]
    ts, te = np_(b.tile_start), np_(b.tile_stop)
    for t in range(ts.shape[0]):
        np.testing.assert_array_equal(attr_c[:, ts[t]:te[t]],
                                      packed[:, ts[t]:te[t]], err_msg=f"tile {t}")
    np.testing.assert_array_equal(attr_c[TP.VALID_ROW] > 0.5,
                                  np_(b.pair_tile) < ts.shape[0])


@pytest.mark.parametrize("presort,max_hits", [("exact", 512), (False, 24)])
def test_render_carry_attrs_bit_identical(presort, max_hits):
    p, vm, intr = _case(64, 48, 1)
    n = p["means"].shape[0]
    cfg = RasterConfig(img_h=48, img_w=64, tile_h=16, tile_w=16,
                       pair_capacity=8192, max_hits_per_tile=max_hits)
    c_col = torch.from_numpy(np.random.default_rng(3).normal(
        size=(48, 64, 3)).astype(np.float32))
    outs, grads = [], []
    for carry in (False, True):
        tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
        out = render(*[tp[k] for k in NAMES], torch.ones(n, dtype=torch.bool),
                     torch.from_numpy(vm), torch.from_numpy(intr), cfg, 3,
                     torch.zeros(3), presort=presort, carry_attrs=carry)
        loss = (out.color * c_col).sum() + out.final_T.sum()
        grads.append(torch.autograd.grad(loss, [tp[k] for k in NAMES]))
        outs.append(out)
    for f in ("color", "final_T", "n_contrib"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
    for k, a, b in zip(NAMES, *grads):
        assert torch.equal(a, b), k
    assert float(outs[0].color.detach().abs().max()) > 0


@pytest.mark.parametrize("presort", ["exact", False])
def test_render_carry_attrs_matches_jax(presort):
    p, vm, intr = _case(64, 48, 2)
    n = p["means"].shape[0]
    bg = np.float32([0.1, 0.2, 0.3])
    tp = params_from_numpy(p, "cpu")
    got = render(*[tp[k] for k in NAMES], torch.ones(n, dtype=torch.bool),
                 torch.from_numpy(vm), torch.from_numpy(intr),
                 RasterConfig(img_h=48, img_w=64, tile_h=16, tile_w=16,
                              pair_capacity=8192, max_hits_per_tile=512),
                 3, torch.from_numpy(bg), presort=presort, need_grads=False,
                 carry_attrs=True)
    ref = jax_render(*[jnp.asarray(p[k]) for k in NAMES], jnp.ones(n, bool),
                     jnp.asarray(vm), jnp.asarray(intr),
                     JaxConfig(img_h=48, img_w=64, tile_h=16, tile_w=16,
                               pair_capacity=8192, max_hits_per_tile=512),
                     3, jnp.asarray(bg), compositor="pallas", presort=presort,
                     need_grads=False, carry_attrs=True)
    _assert_outputs_match(got, ref)

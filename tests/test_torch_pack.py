"""tpugs_torch attribute packing and the align-copy's plain version against
tpugs' pack helpers and its Pallas align-copy kernel in interpret mode:
bit-identical on every tile's written span."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_projection, np_, random_projection, torch_projection
from tpugs.ops import binning as JB
from tpugs.ops.pallas import pack as JP
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import pack as TP

torch.set_num_threads(1)

CAP = 8192


def _binned(w, h, tile, seed, max_hits):
    d = random_projection(300, w, h, seed, big_rects=True)
    jp, tp = jax_projection(d), torch_projection(d)
    jb, _ = JB.clamp_tile_segments(JB.bin_gaussians(jp, w, h, tile, tile, CAP),
                                   max_hits)
    tb, _ = TB.clamp_tile_segments(TB.bin_gaussians(tp, w, h, tile, tile, CAP),
                                   max_hits)
    return jp, tp, jb, tb


@pytest.mark.parametrize("w,h,tile", [(64, 48, 16), (96, 64, 32)])
@pytest.mark.parametrize("max_hits", [4096, 5])
def test_aligned_offsets_and_pack(w, h, tile, max_hits):
    jp, tp, jb, tb = _binned(w, h, tile, 0, max_hits)
    got = TP.aligned_offsets(tb.tile_start, tb.tile_stop)
    ref = JP.aligned_offsets(jb.tile_start, jb.tile_stop)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert np.all(np_(got[0]) % TP.LANE_ALIGN == 0)
    npairs = int(tb.num_pairs)
    pg = tb.pair_gauss[:npairs]
    attr_t = TP.pack_compact_attrs(pg, tp.means2d, tp.conic, tp.rgb, tp.opac,
                                   npairs + 7)
    attr_j = JP.pack_compact_attrs(jnp.asarray(np_(pg)), jp.means2d, jp.conic,
                                   jp.rgb, jp.opac, npairs + 7)
    np.testing.assert_array_equal(np_(attr_t), np_(attr_j))
    assert TP.aligned_length(got[0], got[2]) <= TP.p_aligned_chunked(CAP, len(got[0]))


@pytest.mark.parametrize("n_tiles,pair_capacity", [(12, 8192), (2040, 1 << 21)])
def test_p_aligned_chunked(n_tiles, pair_capacity):
    assert TP.p_aligned_chunked(pair_capacity, n_tiles) == JP.p_aligned_chunked(
        pair_capacity, n_tiles)


@pytest.mark.parametrize("w,h,tile,seed", [(64, 48, 16, 1), (96, 64, 32, 2),
                                           (96, 64, 16, 3)])
def test_align_copy_matches_pallas_on_written_spans(w, h, tile, seed):
    jp, tp, jb, tb = _binned(w, h, tile, seed, 40)
    npairs = int(tb.num_pairs)
    pg = tb.pair_gauss[:npairs]
    astart, astop, counts = TP.aligned_offsets(tb.tile_start, tb.tile_stop)
    attr_c = TP.pack_compact_attrs(pg, tp.means2d, tp.conic, tp.rgb, tp.opac,
                                   npairs)
    p_al = TP.aligned_length(astart, counts)
    got = np_(TP.align_copy(attr_c, tb.tile_start, astart, counts, p_al))
    assert got.shape == (TP.ATTR_ROWS, p_al)
    # The reference kernel reads and writes CHUNK-wide windows: give it slack.
    pad = TP.CHUNK + 2 * TP.LANE_ALIGN
    ref = np.asarray(JP.align_copy_pallas(
        jnp.asarray(np.pad(np_(attr_c), ((0, 0), (0, pad)))),
        jnp.asarray(np_(tb.tile_start)), jnp.asarray(np_(astart)),
        jnp.asarray(np_(counts)), TP.p_aligned_chunked(CAP, len(counts)),
        interpret=True))
    a0, c = np_(astart), np_(counts)
    for t in range(len(a0)):
        span = -(-c[t] // TP.LANE_ALIGN) * TP.LANE_ALIGN
        np.testing.assert_array_equal(got[:, a0[t]:a0[t] + span],
                                      ref[:, a0[t]:a0[t] + span],
                                      err_msg=f"tile {t}")
    # Gap columns are zero, so the valid row marks exactly the entries.
    assert got[TP.VALID_ROW].sum() == c.sum()

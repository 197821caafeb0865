"""The gradient of render(need_grads=False), the reference's scatter-add
variant (composite_tiles_pallas), against jax.grad of tpugs'
render(need_grads=False, compositor="pallas") on the same numpy inputs,
with the tolerance of tests/test_torch_classic.py's render() gradients;
and the cases in which it must build no graph or refuse."""
import numpy as np
import pytest
import torch

from tests.test_torch_backward import _model
from tests.test_torch_classic import _assert_grads_close, _counting
from tests.torch_parity import np_, render_grads_both
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite as TCOMP

torch.set_num_threads(1)

CAP = 8192


@pytest.mark.parametrize("w,h,tile,seed,presort,cap,max_hits", [
    (64, 48, 16, 0, "exact", CAP, 512), (96, 64, 32, 1, False, CAP, 512),
    (64, 48, 16, 5, "exact", 200, 24),
])
def test_forward_only_render_gradients_match_jax(monkeypatch, w, h, tile, seed,
                                                 presort, cap, max_hits):
    """render(need_grads=False) with inputs that need a gradient: the
    scatter-add gradient in both packages, no reduce_meta built, and the
    truncated case (pairs past the capacity, entries past max_hits) carries
    no gradient in either."""
    scatter = _counting(monkeypatch, TCOMP.CompositeScatter, "backward")
    meta = _counting(monkeypatch, TB, "reduce_intervals")
    p, vm, intr = _model(w, h, seed)
    alive = np.ones(p["means"].shape[0], bool)
    out, jo, got, ref = render_grads_both(p, alive, vm, intr, w, h, tile,
                                          presort, cap=cap, max_hits=max_hits,
                                          seed=seed, need_grads=False)
    assert scatter and not meta
    assert bool(out.pair_overflow) == bool(jo.pair_overflow) == (cap == 200)
    np.testing.assert_allclose(np_(out.color), np.asarray(jo.color), atol=1e-5)
    _assert_grads_close(got, ref)
    assert np.abs(got["probe"]).max() > 0 and np.abs(got["sh"]).max() > 0


def test_scatter_refuses_ids_past_f32():
    from tpugs_torch.ops.rasterize_tiled import RasterConfig

    cfg = RasterConfig(img_h=48, img_w=64, tile_h=16, tile_w=16)
    z = torch.zeros(12, dtype=torch.int32)
    big = torch.empty(((1 << 24) + 1, 2))
    with pytest.raises(ValueError, match="f32 id row"):
        TCOMP.CompositeScatter.apply(cfg, z, z, z[:0], big, big, big, big[:, 0],
                                     torch.zeros(3), 0, None)

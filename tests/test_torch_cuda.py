"""The port's CUDA kernels against their plain versions on the card, and a
render on the card against the same render on the CPU. Marked `cuda`: they
skip where there is no NVIDIA GPU (with nvcc). They import no JAX, so on a
card machine without it run them past tests/conftest.py (which imports JAX):
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`."""
import numpy as np
import pytest
import torch

from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite_t, expand, pack
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
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


def _proj(dev, w, h, seed, n=2000):
    p = params_from_numpy(synthetic_params_numpy(n, seed=seed), dev)
    return project_gaussians(
        *[p[k] for k in NAMES], torch.ones(n, dtype=torch.bool, device=dev),
        torch.eye(4, device=dev),
        torch.as_tensor(synthetic_intrinsics_numpy(w, h), device=dev), w, h, 3)


@pytest.mark.parametrize("tile,qbits,presorted,frac", [
    (16, 0, False, 1.0), (32, 0, False, 0.5), (16, 32, False, 1.0), (32, 0, True, 1.0),
])
def test_expand_kernel_bit_identical(dev, tile, qbits, presorted, frac):
    proj = _proj(dev, 192, 128, 0)
    if presorted:
        proj = TB.presort_by_depth(proj)[1]
    total = TB.expand_inputs(proj, 192, 128, tile, tile, 1 << 24).total
    ex = TB.expand_inputs(proj, 192, 128, tile, tile, int(total * frac),
                          presorted, qbits)
    args = (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile)
    for a, b in zip(expand.expand_pairs(*args), expand.expand_pairs_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_align_copy_and_compositor(dev, tile):
    proj = _proj(dev, 192, 128, 1)
    cfg = RasterConfig(img_h=128, img_w=192, tile_h=tile, tile_w=tile,
                       pair_capacity=1 << 20, max_hits_per_tile=1 << 16)
    b = TB.bin_gaussians_expand_kernel(proj, 192, 128, tile, tile, cfg.pair_capacity)
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

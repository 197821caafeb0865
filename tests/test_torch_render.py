"""tpugs_torch render(), OfflineRenderer and the render CLI against tpugs on
the same model: render() against tpugs' render(compositor="pallas",
need_grads=False) with its kernels in interpret mode, and the CLI's PNGs
within 1 LSB of tpugs.apps.render's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_parity import assert_grads_close, np_, render_grads_both
from tpugs.apps.render import main as jax_render_main
from tpugs.ops.render import RasterConfig as JaxConfig
from tpugs.ops.render import render as jax_render
from tpugs_torch.apps.render import main as torch_render_main
from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.io.ply import write_gaussian_ply_numpy
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.utils.synthetic import synthetic_params_numpy
from tpugs_torch.viewer.camera import orbit_trajectory
from tpugs_torch.viewer.offline import OfflineRenderer

torch.set_num_threads(1)

ATOL = 1e-5
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _case(w, h, seed, n=300):
    p = synthetic_params_numpy(n, seed=seed)
    cam = orbit_trajectory(p["means"], 4, w, h)[seed % 4]
    vm = cam.world_to_camera().astype(np.float32)
    return p, vm, cam.intrinsics_array()


def _both(p, vm, intr, w, h, tile, presort, cap=8192, max_hits=512, bg=(0.1, 0.2, 0.3)):
    n = p["means"].shape[0]
    bg = np.asarray(bg, np.float32)
    tp = params_from_numpy(p, "cpu")
    got = render(*[tp[k] for k in NAMES], torch.ones(n, dtype=torch.bool),
                 torch.from_numpy(vm), torch.from_numpy(intr),
                 RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                              pair_capacity=cap, max_hits_per_tile=max_hits),
                 3, torch.from_numpy(bg), presort=presort, need_grads=False)
    ref = jax_render(*[jnp.asarray(p[k]) for k in NAMES], jnp.ones(n, bool),
                     jnp.asarray(vm), jnp.asarray(intr),
                     JaxConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                               pair_capacity=cap, max_hits_per_tile=max_hits),
                     3, jnp.asarray(bg), compositor="pallas", presort=presort,
                     need_grads=False)
    return got, ref


def _assert_outputs_match(got, ref):
    np.testing.assert_allclose(np_(got.color), np_(ref.color), atol=ATOL)
    np.testing.assert_allclose(np_(got.final_T), np_(ref.final_T), atol=ATOL)
    assert (np_(got.n_contrib) == np_(ref.n_contrib)).mean() >= 0.999
    np.testing.assert_array_equal(np_(got.radii), np_(ref.radii))
    np.testing.assert_array_equal(np_(got.visible), np_(ref.visible))
    np.testing.assert_allclose(np_(got.means2d), np_(ref.means2d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np_(got.depths), np_(ref.depths), rtol=1e-6)
    for f in ("num_pairs", "pair_overflow", "max_tile_hits", "hit_overflow"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f


@pytest.mark.parametrize("w,h,tile,seed,presort", [
    (64, 48, 16, 0, "exact"), (96, 64, 32, 1, False), (96, 64, 16, 2, "qkey"),
    (64, 48, 32, 3, "auto"), (96, 64, 16, 4, "fast"),
])
def test_render_matches_jax(w, h, tile, seed, presort):
    p, vm, intr = _case(w, h, seed)
    got, ref = _both(p, vm, intr, w, h, tile, presort)
    _assert_outputs_match(got, ref)
    assert got.color.shape == (h, w, 3) and np_(got.n_contrib).max() > 1
    assert not bool(got.pair_overflow) and not bool(got.hit_overflow)


def test_render_fast_presort_gradients_match_jax():
    """render(presort="fast") with gradients against tpugs' (its kernel
    branch, interpret mode): image, probe and every parameter's gradient
    (tests/test_torch_backward.py's tolerances); and within tpugs' own
    bound (0.05) of the exact presort's image."""
    p, vm, intr = _case(64, 48, 6)
    alive = np.ones(300, bool)
    out, jo, got, ref = render_grads_both(p, alive, vm, intr, 64, 48, 16,
                                          "fast")
    np.testing.assert_allclose(np_(out.color), np_(jo.color), atol=ATOL)
    assert_grads_close(got, ref)
    exact, _ = _both(p, vm, intr, 64, 48, 16, "exact")
    np.testing.assert_allclose(np_(out.color), np_(exact.color), atol=0.05)


@pytest.mark.parametrize("cap,max_hits", [(150, 512), (8192, 4)])
def test_render_truncation_matches_jax(cap, max_hits):
    """Pair-capacity and per-tile-hit truncation: same flags, same image."""
    p, vm, intr = _case(64, 48, 5)
    got, ref = _both(p, vm, intr, 64, 48, 16, "exact", cap=cap, max_hits=max_hits)
    _assert_outputs_match(got, ref)
    assert bool(got.pair_overflow) == (cap == 150)
    assert bool(got.hit_overflow) == (max_hits == 4)


def test_render_empty_scene_is_background():
    """Every gaussian behind the camera: no pairs, no kernel work, the
    background everywhere."""
    p, _, intr = _case(64, 48, 0, n=40)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = -50.0
    got, ref = _both(p, vm, intr, 64, 48, 16, "exact")
    _assert_outputs_match(got, ref)
    assert int(got.num_pairs) == 0 and np_(got.final_T).min() == 1.0
    np.testing.assert_array_equal(np_(got.color)[5, 7],
                                  np.float32([0.1, 0.2, 0.3]))


def test_render_refuses_gradients():
    """render(need_grads=False) builds an autograd graph only for an input
    that requires a gradient, and then differentiates like
    render(need_grads=True) (its scatter-add gradient against the sorted
    segment sum); with none, no graph stands behind the image."""
    p, vm, intr = _case(64, 48, 0, n=20)
    tp = params_from_numpy(p, "cpu")
    cfg = RasterConfig(img_h=48, img_w=64)
    args = [tp[k] for k in NAMES] + [torch.ones(20, dtype=torch.bool),
                                     torch.from_numpy(vm), torch.from_numpy(intr),
                                     cfg, 3, torch.zeros(3)]
    assert render(*args, need_grads=False).color.grad_fn is None
    grads = []
    for need_grads in (False, True):
        means = tp["means"].clone().requires_grad_(True)
        out = render(means, *args[1:], need_grads=need_grads)
        out.color.sum().backward()
        grads.append(np_(means.grad))
    assert np.abs(grads[1]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5,
                               atol=1e-6 * np.abs(grads[1]).max())


class TestOfflineRenderer:
    def _renderer(self, **kw):
        p = synthetic_params_numpy(300, seed=6)
        logs = []
        r = OfflineRenderer(p, device="cpu", log=logs.append, **kw)
        cam = orbit_trajectory(p["means"], 3, 64, 48)[1]
        return r, cam, logs

    def test_grow_policy_grows_and_matches_roomy_render(self):
        r, cam, logs = self._renderer(pair_capacity=64, max_hits=8)
        img = r.render_camera(cam)
        assert r.pair_capacity > 64 and r.max_hits > 8 and len(logs) >= 1
        roomy, _, _ = self._renderer(pair_capacity=1 << 14, max_hits=1024)
        np.testing.assert_array_equal(img, roomy.render_camera(cam))
        st = r.frame_stats[-1]
        assert (st.width, st.height) == (64, 48) and st.num_pairs > 64
        assert st.max_tile_hits > 8 and st.ms > 0

    def test_warn_and_error_policies(self):
        r, cam, logs = self._renderer(pair_capacity=64, on_overflow="warn")
        r.render_camera(cam)
        r.render_camera(cam)
        assert len(logs) == 1 and "OVERFLOW" in logs[0] and r.pair_capacity == 64
        r, cam, _ = self._renderer(pair_capacity=64, on_overflow="error")
        with pytest.raises(RuntimeError, match="OVERFLOW"):
            r.render_camera(cam)
        with pytest.raises(ValueError):
            self._renderer(on_overflow="nope")

    @pytest.mark.parametrize("mode", ["rgb", "depth", "heatmap"])
    def test_modes(self, mode):
        r, cam, _ = self._renderer()
        img = r.render_camera(cam, mode=mode)
        assert img.shape == (48, 64, 3) and 0.0 <= img.min() and img.max() <= 1.0


def _ply(tmp_path, n=300, seed=8):
    p = synthetic_params_numpy(n, seed=seed)
    path = tmp_path / "model.ply"
    write_gaussian_ply_numpy(path, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    return str(path)


@pytest.mark.parametrize("mode,tile", [("rgb", 16), ("heatmap", 32)])
def test_cli_pngs_match_jax_cli(tmp_path, capsys, mode, tile):
    ply = _ply(tmp_path)
    common = ["-m", ply, "--frames", "2", "--width", "64", "--height", "48",
              "--mode", mode, "--tile", str(tile), "--background", "0.1", "0", "0.2"]
    assert torch_render_main(common + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jax_render_main(common + ["-o", str(tmp_path / "j")]) == 0
    out = capsys.readouterr().out
    assert "frame 0001: 64x48 pairs" in out
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "t" / f"frame_{i:04d}.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / "j" / f"frame_{i:04d}.png"), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        assert np.abs(a - b).max() <= 1
        assert a.max() > 0


def test_cli_dataset_cameras_match_jax_cli(tmp_path, capsys):
    """-d renders the dataset's test cameras (every 8th image, at its own
    size), as tpugs' CLI does: the same PNGs within 1 LSB."""
    from tests.synthetic_scene import make_scene

    root = str(tmp_path / "scene")
    make_scene(root, num_images=10, width=64, height=48, num_points=60)
    ply = _ply(tmp_path)
    common = ["-m", ply, "-d", root, "--tile", "16"]
    assert torch_render_main(common + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jax_render_main(common + ["-o", str(tmp_path / "j")]) == 0
    assert "frame 0001: 64x48 pairs" in capsys.readouterr().out
    names = sorted(q.name for q in (tmp_path / "t").iterdir())
    assert names == sorted(q.name for q in (tmp_path / "j").iterdir())
    assert names == ["frame_0000.png", "frame_0001.png"]
    for name in names:
        a = np.asarray(Image.open(tmp_path / "t" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "j" / name), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        assert np.abs(a - b).max() <= 1
        assert a.max() > 0

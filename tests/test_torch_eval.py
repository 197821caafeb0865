"""Evaluation in tpugs_torch against tpugs on the same inputs: PSNR and
SSIM, evaluate_views, Trainer.evaluate (and its overflow growth, and the
train loop's eval_every), the eval CLI's metrics.json, the debug checks
around the compositor, and a tiny run of the quality CLI.

Tolerances, with their reasons:
- PSNR, SSIM of given images: rtol 1e-6 (one mean and a log10; SSIM's
  blur summed in another order);
- Trainer.evaluate and the eval CLI: mean PSNR within 1e-3 dB and SSIM
  within 1e-5: the two renders agree to float32 rounding (the JAX package
  composites with its scan here, the port with the forward kernel's plain
  version);
- the eval lines of a run with eval_every: within 0.011 dB and 1.1e-4
  (printed to 2 and 4 decimals, after steps whose losses agree to 1e-4);
- checked_render against render(): atol 1e-5 (the scan and the kernel's
  plain version add in another order).
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.torch_parity import np_
from tpugs.apps.eval import main as jax_eval_main
from tpugs.train import metrics as JMet
from tpugs.train.trainer import TrainConfig as JaxTrainConfig
from tpugs.train.trainer import Trainer as JaxTrainer
from tpugs_torch.apps.eval import main as torch_eval_main
from tpugs_torch.apps.quality import main as quality_main
from tpugs_torch.core.gaussians import train_state_from_numpy
from tpugs_torch.io.ply import write_gaussian_ply_numpy
from tpugs_torch.ops import binning as B
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.train import metrics as TMet
from tpugs_torch.train.trainer import TrainConfig, Trainer, initial_key
from tpugs_torch.utils.checks import checked_composite, checked_render
from tpugs_torch.utils.gt_scene import make_gt_model
from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                         synthetic_params)

torch.set_num_threads(1)

NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "s")
    make_scene(root, num_images=10, width=64, height=48, num_points=60)
    return root


def _pair(seed=0, h=48, w=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_and_ssim_match_jax():
    a, b = _pair()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(TMet.compute_psnr(ta, tb)),
                               float(JMet.compute_psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(TMet.compute_ssim(ta, tb)),
                               float(JMet.compute_ssim(a, b)), rtol=1e-6)
    assert float(TMet.compute_psnr(ta, ta)) == 100.0


def test_evaluate_views_matches_jax(tmp_path):
    """The same noisy renders (some out of [0, 1], clipped by both) scored
    by both, and the same JSON keys."""
    views = []
    for i in range(3):
        a, b = _pair(i)
        views.append((f"v{i}", a, (b * 1.2 - 0.1).astype(np.float32)))
    ours = TMet.evaluate_views(lambda x: torch.from_numpy(x),
                               views, num_gaussians=7)
    ref = JMet.evaluate_views(lambda x: jnp.asarray(x), views, num_gaussians=7)
    a, b = ours.to_json(), ref.to_json()
    assert a.keys() == b.keys() and a["num_images"] == 3
    for k in ("mean_psnr", "mean_ssim"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    for r, s in zip(a["images"], b["images"]):
        assert r.keys() == s.keys() and r["name"] == s["name"]
        np.testing.assert_allclose([r["psnr"], r["ssim"]], [s["psnr"], s["ssim"]],
                                   rtol=1e-6)
    ours.save_json(str(tmp_path / "m.json"))
    assert json.load(open(tmp_path / "m.json"))["num_gaussians"] == 7


def _cfg(cls, out, **kw):
    base = dict(capacity=128, sh_degree=1, log_every=5, save_every=0,
                densify_mode="none", pair_capacity=1 << 14,
                max_hits_per_tile=128, output_dir=out)
    base.update(kw)
    return cls(**base)


def _port_state_from(jt):
    """The port's TrainState from a JAX Trainer's."""
    s = jax.tree.map(np.asarray, jt.state)
    flat = {f"params/{k}": v for k, v in s.params.items()}
    flat.update({f"adam_m/{k}": v for k, v in s.adam.m.items()})
    flat.update({f"adam_v/{k}": v for k, v in s.adam.v.items()})
    flat.update(alive=s.alive, adam_count=s.adam.count, key=initial_key(0),
                adc_grad_accum=s.adc.grad_accum,
                adc_grad_count=s.adc.grad_count, adc_max_radii=s.adc.max_radii)
    return train_state_from_numpy(flat, "cpu")


def _close(res, ref, dpsnr=1e-3, dssim=1e-5):
    assert len(res.images) == len(ref.images) == 2
    assert abs(res.mean_psnr - ref.mean_psnr) <= dpsnr
    assert abs(res.mean_ssim - ref.mean_ssim) <= dssim
    assert res.num_gaussians == ref.num_gaussians
    assert [r.name for r in res.images] == [r.name for r in ref.images]


def test_trainer_evaluate_matches_jax(scene, tmp_path):
    """The JAX Trainer's state after 10 steps, evaluated by both."""
    jt = JaxTrainer(scene, _cfg(JaxTrainConfig, str(tmp_path / "j")),
                    log_fn=lambda *_: None)
    jt.train(10)
    tr = Trainer(scene, _cfg(TrainConfig, str(tmp_path / "t")),
                 log_fn=lambda *_: None, device="cpu")
    tr.state = _port_state_from(jt)
    for deg in (None, 0):
        res, ref = tr.evaluate(deg), jt.evaluate(deg)
        _close(res, ref)
        assert 5.0 < res.mean_psnr < 100.0


@pytest.mark.parametrize("policy", ["grow", "warn", "error"])
def test_eval_overflow_matches_jax(scene, tmp_path, policy):
    """Eval capacities too small for the test views: "grow" grows them
    (on their own, not training's) and scores the full render, "warn" logs
    and scores the truncated one, "error" raises; as the reference."""
    kw = dict(auto_pair_capacity=False, pair_capacity=64, max_hits_per_tile=4,
              on_overflow=policy)
    logs, jlogs = [], []
    tr = Trainer(scene, _cfg(TrainConfig, str(tmp_path / "t"), **kw),
                 log_fn=logs.append, device="cpu")
    jt = JaxTrainer(scene, _cfg(JaxTrainConfig, str(tmp_path / "j"), **kw),
                    log_fn=jlogs.append)
    if policy == "error":
        with pytest.raises(RuntimeError, match="eval view .* OVERFLOW"):
            tr.evaluate()
        return
    res, ref = tr.evaluate(), jt.evaluate()
    _close(res, ref)
    grow = lambda ls: [ln.replace(" (re-jit, eval only)", " (eval only)")
                       for ln in ls if "OVERFLOW" in ln]
    assert grow(logs) == grow(jlogs) and grow(logs)
    er, jer = tr._eval_raster, jt._eval_raster
    assert (er.pair_capacity, er.max_hits_per_tile) == (
        jer.pair_capacity, jer.max_hits_per_tile)
    assert (tr.raster.pair_capacity, tr.raster.max_hits_per_tile) == (64, 4)
    if policy == "grow":
        assert er.pair_capacity > 64 and er.max_hits_per_tile > 4


def test_eval_every_evaluates_at_the_warmup_degree(scene, tmp_path):
    """eval_every > 0 evaluates during training, at the SH degree of the
    step (0 before step 1000 with sh_degree 1), as the reference."""
    logs, jlogs, degs, jdegs = [], [], [], []
    kw = dict(eval_every=5, iterations=10)
    tr = Trainer(scene, _cfg(TrainConfig, str(tmp_path / "t"), **kw),
                 log_fn=logs.append, device="cpu")
    jt = JaxTrainer(scene, _cfg(JaxTrainConfig, str(tmp_path / "j"), **kw),
                    log_fn=jlogs.append)
    for t, d in ((tr, degs), (jt, jdegs)):
        orig = t.evaluate
        t.evaluate = lambda sh_degree=None, o=orig, d=d: (
            d.append(sh_degree), o(sh_degree))[1]
    tr.train(10)
    jt.train(10)
    assert degs == jdegs == [0]
    pat = r"\[(\d+)\] eval: PSNR ([\d.]+) dB  SSIM ([\d.]+) \((\d+) views\)"
    got = [re.match(pat, ln).groups() for ln in logs if "eval:" in ln]
    ref = [re.match(pat, ln).groups() for ln in jlogs if "eval:" in ln]
    assert [g[0] for g in got] == [r[0] for r in ref] == ["5"]
    assert got[0][3] == ref[0][3] == "2"
    assert abs(float(got[0][1]) - float(ref[0][1])) <= 0.011
    assert abs(float(got[0][2]) - float(ref[0][2])) <= 1.1e-4


@pytest.fixture(scope="module")
def model_ply(tmp_path_factory):
    m = {k: np_(v) for k, v in make_gt_model(300, seed=1, sh_coeffs=4,
                                             device="cpu").items()}
    path = tmp_path_factory.mktemp("ply") / "m.ply"
    write_gaussian_ply_numpy(path, m["means"], m["sh"], m["opacity_logits"],
                             m["log_scales"], m["quats"])
    return str(path)


def test_eval_cli_matches_jax(scene, model_ply, tmp_path, monkeypatch):
    argv = ["-m", model_ply, "-d", scene, "--pair-capacity", "4096",
            "--max-hits", "256"]
    assert torch_eval_main(argv + ["-o", str(tmp_path / "t.json"),
                                   "--device", "cpu"]) == 0
    assert torch_eval_main(argv + ["-o", str(tmp_path / "d.json"),
                                   "--device", "cpu", "--debug-checks"]) == 0
    assert jax_eval_main(argv + ["-o", str(tmp_path / "j.json")]) == 0
    ours, dbg, ref = (json.load(open(tmp_path / f))
                      for f in ("t.json", "d.json", "j.json"))
    assert ours.keys() == ref.keys()
    assert ours["num_gaussians"] == ref["num_gaussians"] == 300
    assert [i["name"] for i in ours["images"]] == [i["name"] for i in ref["images"]]
    for other in (ref, dbg):
        assert abs(ours["mean_psnr"] - other["mean_psnr"]) <= 1e-3
        assert abs(ours["mean_ssim"] - other["mean_ssim"]) <= 1e-5
    assert 5.0 < ours["mean_psnr"] < 100.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_eval_main(argv + ["-o", str(tmp_path / "x.json")])


W, H, N = 64, 48, 32
CFG = RasterConfig(img_h=H, img_w=W, tile_h=16, tile_w=16,
                   pair_capacity=1 << 12, max_hits_per_tile=128)


def _sound():
    p = synthetic_params(N, seed=0, sh_coeffs=1)
    alive = torch.ones(N, dtype=torch.bool)
    intr = torch.from_numpy(synthetic_intrinsics_numpy(W, H))
    return p, alive, intr


@pytest.fixture(scope="module")
def inputs():
    """The compositor's inputs of a sound scene, as tests/test_checks.py
    builds them for the reference."""
    p, alive, intr = _sound()
    proj = project_gaussians(p["means"], p["quats"], p["log_scales"],
                             p["opacity_logits"], p["sh"], alive, torch.eye(4),
                             intr, W, H, 0)
    b = B.bin_gaussians_expand_kernel(proj, W, H, 16, 16, CFG.pair_capacity)
    return dict(tile_start=b.tile_start, tile_stop=b.tile_stop,
                pair_gauss=b.pair_gauss, means2d=proj.means2d, conic=proj.conic,
                rgb=proj.rgb, opac=proj.opac, background=torch.zeros(3))


def _run(inputs, compositor="scan", **poison):
    a = dict(inputs)
    for k, (idx, v) in poison.items():
        a[k] = a[k].clone()
        a[k][idx] = v
    return checked_composite(CFG, a["tile_start"], a["tile_stop"],
                             a["pair_gauss"], a["means2d"], a["conic"],
                             a["rgb"], a["opac"], a["background"],
                             compositor=compositor)


@pytest.mark.parametrize("compositor,poison,match", [
    ("scan", dict(means2d=((3, 0), float("nan"))), "non-finite means2d"),
    ("scan", dict(conic=((0, 1), float("inf"))), "non-finite conic"),
    ("scan", dict(pair_gauss=(0, N + 7)), "index out of bounds"),
    ("scan", dict(tile_start=(0, 10**6)), "stop < start"),
    ("scan", dict(opac=(2, 1.5)), "opacity outside"),
    ("kernel", dict(rgb=((1, 2), float("nan"))), "non-finite rgb"),
])
def test_checked_composite_raises_as_the_reference(inputs, compositor, poison,
                                                   match):
    with pytest.raises(ValueError, match=match):
        _run(inputs, compositor, **poison)


def test_checked_render_matches_render():
    p, alive, intr = _sound()
    out = render(*[p[k] for k in NAMES], alive, torch.eye(4), intr, CFG, 0,
                 torch.zeros(3), need_grads=False)
    for comp in ("auto", "kernel"):
        img = checked_render(p, alive, torch.eye(4), intr, CFG, 0,
                             np.zeros(3, np.float32), compositor=comp)
        np.testing.assert_allclose(np_(img), np_(out.color), atol=1e-5)
    assert float(out.color.max()) > 0.1
    with pytest.raises(ValueError, match="non-finite means2d"):
        bad = dict(p, means=p["means"].clone())
        bad["means"][0, 0] = float("nan")
        checked_render(bad, alive, torch.eye(4), intr, CFG, 0, np.zeros(3))


def test_quality_cli_tiny_run(tmp_path, capsys):
    argv = ["-i", "10", "-o", str(tmp_path), "--gaussians", "300", "--views",
            "9", "--width", "64", "--height", "48", "--capacity", "1024",
            "--log-every", "5", "--device", "cpu"]
    assert quality_main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "quality_psnr_synthetic_gt"
    assert 0.0 < line["value"] < 100.0 and line["iterations"] == 10
    saved = json.load(open(tmp_path / "quality.json"))
    assert saved["num_images"] == 2 and saved["num_gaussians"] > 0
    # The same run on a 1x1 mesh: the mesh's step, no process group.
    mesh_dir = tmp_path / "mesh"
    argv[argv.index("-o") + 1] = str(mesh_dir)
    assert quality_main(argv + ["--mesh", "data=1,gauss=1"]) == 0
    mesh_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mesh_line["metric"] == "quality_psnr_synthetic_gt"
    assert 0.0 < mesh_line["value"] < 100.0
    assert json.load(open(mesh_dir / "quality.json"))["num_gaussians"] > 0

"""The training slice's pieces against tpugs on the same numpy inputs: the
L1 + SSIM loss and its gradient, Adam, the LR schedule, initialisation from
SfM points, the COLMAP loader and Dataset, the GT scene writer, checkpoints
(read by the other package), the Trainer and the train CLI.

Tolerances, with their reasons:
- loss, its gradient, Adam over 3 steps, LR: rtol 1e-5 (XLA's and torch's
  exp, log, pow and matmul sums differ at ulp scale);
- init: log scales rtol 1e-5 (kNN distances summed in float32), the other
  fields exact;
- GT images within 1 LSB (the orbit's target is a float32 mean, summed in
  another order);
- Trainer and CLI: the same views in the same order, per-step losses within
  rtol 1e-4; final params within steps x 2 x the group's lr on >= 99.9% of
  elements. Adam's eps = 1e-15 turns a ulp-level difference in a gradient
  near zero into a full lr-sized step of either sign, so one step may move
  an element by up to 2 lr against the reference.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.synthetic_scene import make_scene
from tests.torch_parity import np_
from tpugs.apps.train import main as jax_train_main
from tpugs.core.init import init_from_sfm as jax_init
from tpugs.core.init import mean_knn_distance as jax_knn
from tpugs.data.dataset import Dataset as JaxDataset
from tpugs.io.checkpoint import load_train_checkpoint as jax_load
from tpugs.io.checkpoint import save_train_checkpoint as jax_save
from tpugs.optim import adam as JA
from tpugs.optim import lr_schedule as JL
from tpugs.train import loss as JLoss
from tpugs.train.trainer import TrainConfig as JaxTrainConfig
from tpugs.train.trainer import Trainer as JaxTrainer
from tpugs.utils import gt_scene as JG
from tpugs.utils import memory as JM
from tpugs_torch.apps.train import main as torch_train_main
from tpugs_torch.core.gaussians import GaussianState
from tpugs_torch.core.init import init_from_sfm, mean_knn_distance
from tpugs_torch.data import colmap as TCol
from tpugs_torch.data.dataset import Dataset
from tpugs_torch.io.checkpoint import load_train_checkpoint, save_train_checkpoint
from tpugs_torch.optim import adam as TA
from tpugs_torch.optim import lr_schedule as TL
from tpugs_torch.train import loss as TLoss
from tpugs_torch.train.trainer import (TrainConfig, Trainer, train_config_from_dict)
from tpugs_torch.utils import gt_scene as TG
from tpugs_torch.utils import memory as TM

torch.set_num_threads(1)

RTOL = 1e-5
LOSS_RTOL = 1e-4
MIN_CLOSE = 0.999
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _images(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    a[:16, :20] = 0.0  # flat black patches: variance exactly 0 (a tie)
    b[:16, :20] = 0.0
    return a, b


@pytest.mark.parametrize("lam", [0.2, 1.0])
def test_combined_loss_and_gradient_match_jax(lam):
    a, b = _images()
    ta = torch.from_numpy(a).requires_grad_(True)
    loss = TLoss.combined_loss(ta, torch.from_numpy(b), lam)
    (g,) = torch.autograd.grad(loss, [ta])
    jl, jg = jax.value_and_grad(
        lambda x: JLoss.combined_loss(x, jnp.asarray(b), lam))(jnp.asarray(a))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    np.testing.assert_allclose(np_(g), np.asarray(jg), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(np_(TLoss.ssim(ta, torch.from_numpy(b))),
                               np.asarray(JLoss.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(TLoss._blur_matrix_np(48, 11),
                                  JLoss._blur_matrix_np(48, 11))


def _params(n, seed, sh_c=4):
    rng = np.random.default_rng(seed)
    return {
        "means": rng.normal(size=(n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "log_scales": rng.normal(-3, 1, (n, 3)).astype(np.float32),
        "opacity_logits": rng.normal(size=n).astype(np.float32),
        "sh": rng.normal(size=(n, 3, sh_c)).astype(np.float32),
    }


def test_adam_three_steps_match_jax():
    p = _params(50, 0)
    grads = [_params(50, s + 1) for s in range(3)]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = TA.adam_init(tp), JA.adam_init(jp)
    cfg_t, cfg_j = TA.AdamConfig(), JA.AdamConfig()
    for step, g in enumerate(grads):
        tp, ts = TA.adam_step(cfg_t, ts, tp, {k: torch.from_numpy(v) for k, v in g.items()},
                              torch.tensor(float(step)))
        jp, js = JA.adam_step(cfg_j, js, jp, {k: jnp.asarray(v) for k, v in g.items()},
                              jnp.asarray(step, jnp.float32))
    assert int(ts.count) == int(js.count) == 3
    for k in NAMES:
        np.testing.assert_allclose(np_(tp[k]), np.asarray(jp[k]), rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(np_(ts.m[k]), np.asarray(js.m[k]), rtol=RTOL)
        np.testing.assert_allclose(np_(ts.v[k]), np.asarray(js.v[k]), rtol=RTOL)
    lr_t = TA.group_lrs(cfg_t, 10.0)
    lr_j = JA.group_lrs(cfg_j, jnp.float32(10.0))
    assert set(lr_t) == set(lr_j) == set(NAMES)


@pytest.mark.parametrize("step", [0, 1, 999, 15000, 30000, 45000])
def test_position_lr_and_sh_schedule_match_jax(step):
    np.testing.assert_allclose(float(TL.position_lr(float(step))),
                               float(JL.position_lr(jnp.float32(step))), rtol=RTOL)
    for deg in (0, 1, 3):
        assert (TL.active_sh_degree_for_step(step, deg)
                == JL.active_sh_degree_for_step(step, deg))


def test_init_from_sfm_matches_jax_and_not_the_block():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    pts[5] = pts[6]  # a duplicate point: its nearest distance is 0
    rgb = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    gs = init_from_sfm(pts, rgb, capacity=1024, max_sh_degree=2, device="cpu")
    js = jax_init(pts, rgb, capacity=1024, max_sh_degree=2)
    for k in NAMES:
        tol = RTOL if k == "log_scales" else 0.0
        np.testing.assert_allclose(np_(getattr(gs, k)), np.asarray(getattr(js, k)),
                                   rtol=tol, atol=1e-7 if tol else 0, err_msg=k)
    np.testing.assert_array_equal(np_(gs.alive), np.asarray(js.alive))
    p = torch.from_numpy(pts)
    d = mean_knn_distance(p)
    for block in (1, 7, 256):
        assert torch.equal(mean_knn_distance(p, block=block), d)
    np.testing.assert_allclose(np_(d), np.asarray(jax_knn(jnp.asarray(pts))), rtol=RTOL)
    arrays = gs.compact_arrays()
    assert arrays["means"].shape == (700, 3) and arrays["sh"].shape == (700, 3, 9)


def test_gaussian_state_create_and_params():
    p = _params(10, 4)
    gs = GaussianState.create(**p, capacity=16, device="cpu")
    assert gs.capacity == 16 and int(gs.alive.sum()) == 10
    assert set(gs.params()) == set(NAMES)
    np.testing.assert_array_equal(gs.compact_arrays()["quats"], p["quats"])
    assert not gs.means[10:].any()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "s")
    make_scene(root, num_images=10, width=64, height=48, num_points=60)
    return root


@pytest.mark.parametrize("scale", [1, 2])
def test_colmap_and_dataset_match_jax(scene, scale):
    ds, js = Dataset(scene, scale), JaxDataset(scene, scale)
    np.testing.assert_array_equal(ds.points_xyz, js.points_xyz)
    np.testing.assert_array_equal(ds.points_rgb, js.points_rgb)
    for a, b in zip(ds.train_cameras + ds.test_cameras,
                    js.train_cameras + js.test_cameras):
        assert (a.image_name, a.width, a.height) == (b.image_name, b.width, b.height)
        np.testing.assert_array_equal(a.world_to_camera(), b.world_to_camera())
        np.testing.assert_array_equal(a.intrinsics_array(), b.intrinsics_array())
    assert (ds.num_train(), ds.num_test()) == (js.num_train(), js.num_test()) == (8, 2)
    np.testing.assert_array_equal(ds.load_train_image(3), js.load_train_image(3))
    assert ds.scene_bounds.extent == js.scene_bounds.extent
    np.testing.assert_array_equal(ds.scene_bounds.center, js.scene_bounds.center)


def test_points3d_parse_with_tracks(tmp_path):
    """A points3D.bin with tracks takes the record-by-record path."""
    import struct

    path = tmp_path / "points3D.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 2))
        for i, track in enumerate((3, 0)):
            f.write(struct.pack("<q", i))
            f.write(np.asarray([i, 2.0 * i, -1.0], "<f8").tobytes())
            f.write(np.asarray([10, 20, 30 + i], "u1").tobytes())
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", track))
            f.write(b"\0" * 8 * track)
    xyz, rgb = TCol.parse_points3d_bin(str(path))
    np.testing.assert_array_equal(xyz, [[0, 0, -1], [1, 2, -1]])
    np.testing.assert_array_equal(rgb, [[10, 20, 30], [10, 20, 31]])


def test_write_gt_dataset_matches_jax(tmp_path):
    model = TG.make_gt_model(400, seed=2, device="cpu")
    jmodel = JG.make_gt_model(400, seed=2)
    for k in NAMES:
        np.testing.assert_array_equal(np_(model[k]), np.asarray(jmodel[k]), err_msg=k)
    kw = dict(num_views=3, width=64, height=48, sparse_points=150, sh_degree=3)
    TG.write_gt_dataset(str(tmp_path / "t"), model, **kw)
    JG.write_gt_dataset(str(tmp_path / "j"), jmodel, **kw)
    for i in range(3):
        a, b = (np.asarray(Image.open(tmp_path / d / "images" / f"render_{i:03d}.png"),
                           np.int16) for d in ("t", "j"))
        assert np.abs(a - b).max() <= 1 and a.max() > 0
    for name in ("cameras.bin", "points3D.bin"):
        assert ((tmp_path / "t" / "sparse" / "0" / name).read_bytes()
                == (tmp_path / "j" / "sparse" / "0" / name).read_bytes()), name
    ds, js = Dataset(str(tmp_path / "t")), JaxDataset(str(tmp_path / "j"))
    for a, b in zip(ds.train_cameras, js.train_cameras):
        np.testing.assert_allclose(a.world_to_camera(), b.world_to_camera(), atol=1e-6)


def _port_state(seed=0, n=32):
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.train.trainer import TrainState, initial_key

    p = {k: torch.from_numpy(v) for k, v in _params(n, seed).items()}
    adam = TA.adam_init(p)
    adam.m = {k: v + 1 for k, v in adam.m.items()}
    adam.count = torch.tensor(7, dtype=torch.int32)
    adc = adc_init(n, "cpu")
    adc.grad_accum += 0.5
    return TrainState(params=p, alive=torch.arange(n) < n - 3, adam=adam,
                      adc=adc, key=initial_key(seed))


def _fields(state):
    out = {f"params/{k}": np_(v) for k, v in state.params.items()}
    out.update({f"adam_m/{k}": np_(v) for k, v in state.adam.m.items()})
    out.update({f"adam_v/{k}": np_(v) for k, v in state.adam.v.items()})
    out.update(alive=np_(state.alive), adam_count=np_(state.adam.count),
               adc_grad_accum=np_(state.adc.grad_accum),
               adc_grad_count=np_(state.adc.grad_count),
               adc_max_radii=np_(state.adc.max_radii))
    return out


def test_checkpoints_cross_load(tmp_path):
    state = _port_state()
    save_train_checkpoint(str(tmp_path / "port.npz"), state, 7)
    jstate, step = jax_load(str(tmp_path / "port.npz"))
    assert step == 7
    ref = _fields(state)
    for k, v in _fields(jstate).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
        assert v.dtype == ref[k].dtype, k
    jax_save(str(tmp_path / "jax.npz"), jstate, 9)
    back, step = load_train_checkpoint(str(tmp_path / "jax.npz"), "cpu")
    assert step == 9
    for k, v in _fields(back).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert back.key.dtype == np.uint32 and back.key.shape == (2,)


def test_memory_estimate_and_watchdog_match_jax(monkeypatch):
    args = (1 << 17, 16, 1 << 21, 840, 1297, 4)
    assert str(TM.estimate_train_memory_mb(*args)) == str(JM.estimate_train_memory_mb(*args))
    assert TM.device_memory_stats("cpu") == {}
    assert not TM.MemoryWatchdog(device="cpu").enabled
    readings = iter([3000, 3000, 100, 3000, 3000, 3000])
    stats = lambda: {"bytes_limit": 2048 << 20, "bytes_in_use": next(readings) << 20}
    logs = []
    wd = TM.MemoryWatchdog(limit_mb=2000, max_critical_streak=3, stats_fn=stats,
                           log=logs.append)
    got = [wd.check() for _ in range(6)]
    assert got == ["critical", "critical", "ok", "critical", "critical", "critical"]
    assert wd.should_abort() and len(logs) == 5
    TM.check_memory_budget(1 << 30, 16, 1 << 21, 840, 1297, 4)  # no stats
    monkeypatch.setattr(TM, "device_memory_stats",
                        lambda device=None: {"bytes_limit": 80 << 30})
    with pytest.raises(MemoryError):
        TM.check_memory_budget(1 << 30, 16, 1 << 21, 840, 1297, 4)


def test_train_config_sections_match_jax():
    import dataclasses

    d = {"iterations": 5, "adam": {"beta1": 0.8}, "adc": {"densify_every": 50},
         "mcmc": {"relocate_every": 7}}
    cfg = train_config_from_dict(d)
    assert cfg.adam.beta1 == 0.8 and cfg.mcmc.relocate_every == 7
    for ours, ref in ((TrainConfig, JaxTrainConfig),
                      (type(cfg.adam), JA.AdamConfig)):
        assert ([f.name for f in dataclasses.fields(ours)]
                == [f.name for f in dataclasses.fields(ref)])
    with pytest.raises(ValueError, match="unknown"):
        train_config_from_dict({"adam": {"beta3": 1}})


def test_random_background_follows_the_key():
    """--random-bg draws each step's background from the state's key:
    the same key, the same colour; the next key, another one."""
    from tpugs_torch.train.trainer import _background, initial_key

    key = initial_key(3)
    a, b = _background(key, True, "cpu"), _background(key, True, "cpu")
    c = _background(key + np.asarray([0, 1], np.uint32), True, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < 1)).all()
    assert not _background(key, False, "cpu").any()


class _Recorder:
    """Wraps the Trainer's numpy Generator and records its view draws."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def integers(self, *a, **kw):
        out = self.rng.integers(*a, **kw)
        self.draws.append(np.asarray(out).tolist())
        return out


def _train_cfg(cls, out, log_every=1, **kw):
    return cls(iterations=30, capacity=128, sh_degree=1, log_every=log_every,
               save_every=0, densify_mode="none", pair_capacity=1 << 14,
               max_hits_per_tile=128, output_dir=out, **kw)


def _assert_params_close(p, ref, lrs, steps):
    for k in NAMES:
        a, b = np_(p[k]), np.asarray(ref[k])
        assert np.isfinite(a).all()
        close = np.abs(a - b) <= steps * 2 * lrs[k] + 1e-6
        assert close.mean() >= MIN_CLOSE, (k, close.mean())


def test_trainer_matches_jax(scene, tmp_path):
    """Both Trainers, densify_mode="none", 30 steps: the same view draws and
    per-step losses; the JAX Trainer runs its scan compositor here, so this
    holds the port's whole step against an independent path."""
    tr = Trainer(scene, _train_cfg(TrainConfig, str(tmp_path / "t"),
                                   steps_per_call=8),
                 log_fn=lambda *_: None, device="cpu")
    jt = JaxTrainer(scene, _train_cfg(JaxTrainConfig, str(tmp_path / "j"),
                                      steps_per_call=8),
                    log_fn=lambda *_: None)
    tr._rng, jt._rng = _Recorder(tr._rng), _Recorder(jt._rng)
    hist, jhist = tr.train(30), jt.train(30)
    assert tr._rng.draws == jt._rng.draws and len(tr._rng.draws) == 30
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == list(range(30))
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=LOSS_RTOL)
    assert hist[-1]["loss"] < hist[0]["loss"]
    lrs = {k: float(v) for k, v in TA.group_lrs(TA.AdamConfig(), 0.0).items()}
    _assert_params_close(tr.state.params, jt.state.params, lrs, 30)
    np.testing.assert_array_equal(np_(tr.state.alive), np.asarray(jt.state.alive))
    assert int(tr.state.adam.count) == 30
    assert os.path.exists(tmp_path / "t" / "ckpt_0000030.npz")


def test_trainer_block_draws_match_jax(scene, tmp_path):
    """With log_every 5 and steps_per_call 25 both draw views in blocks of
    5, and resume from a checkpoint draws the same as a straight run."""
    cfg = dict(log_every=5, steps_per_call=25)
    tr = Trainer(scene, _train_cfg(TrainConfig, str(tmp_path / "t"), **cfg),
                 log_fn=lambda *_: None, device="cpu")
    jt = JaxTrainer(scene, _train_cfg(JaxTrainConfig, str(tmp_path / "j"), **cfg),
                    log_fn=lambda *_: None)
    assert tr._effective_steps_per_call() == jt._effective_steps_per_call() == 5
    tr._rng, jt._rng = _Recorder(tr._rng), _Recorder(jt._rng)
    tr.train(10)
    jt.train(10)
    assert tr._rng.draws == jt._rng.draws and [len(d) for d in tr._rng.draws] == [5, 5]
    resumed = Trainer(scene, _train_cfg(TrainConfig, str(tmp_path / "t"), **cfg),
                      log_fn=lambda *_: None, device="cpu",
                      resume_from=str(tmp_path / "t" / "ckpt_0000010.npz"))
    assert resumed.start_step == 10
    for k in NAMES:
        assert torch.equal(resumed.state.params[k], tr.state.params[k])


def test_train_cli_matches_jax(scene, tmp_path):
    args = ["-d", scene, "-i", "20", "--capacity", "128", "--sh-degree", "1",
            "--log-every", "5", "--save-every", "10", "--no-densify",
            "--pair-capacity", "16384", "--max-hits", "128"]
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    assert torch_train_main(args + ["-o", t_out, "--device", "cpu"]) == 0
    assert jax_train_main(args + ["-o", j_out]) == 0
    hist = [json.loads(x) for x in open(os.path.join(t_out, "history.jsonl"))]
    jhist = [json.loads(x) for x in open(os.path.join(j_out, "history.jsonl"))]
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 5, 10, 15]
    for key in ("loss", "l1"):
        np.testing.assert_allclose([h[key] for h in hist], [h[key] for h in jhist],
                                   rtol=LOSS_RTOL)
    assert (sorted(os.path.basename(p) for p in glob.glob(t_out + "/*"))
            == sorted(os.path.basename(p) for p in glob.glob(j_out + "/*")))
    state, step = load_train_checkpoint(os.path.join(t_out, "ckpt_0000020.npz"),
                                        "cpu")
    assert step == 20 and int(state.adam.count) == 20


def _cli_config(module, argv):
    args = module.build_parser().parse_args(argv)
    return module.config_from_args(args, module._given_args(argv))


@pytest.mark.parametrize("argv,cfg_file", [
    (["-d", "x"], None),
    (["-d", "x", "-i", "123", "--mcmc", "--tile", "16", "--random-bg"], None),
    (["-d", "x", "-c", "CFG", "-i", "42", "--densify-every", "7"],
     {"iterations": 777, "seed": 3, "tile_h": 16, "tile_w": 16,
      "adc": {"densify_every": 250}, "adam": {"beta1": 0.8}}),
    (["-d", "x", "-c", "CFG", "--no-densify", "--final-opacity-reset"],
     {"densify_mode": "mcmc", "mcmc": {"relocate_every": 50}}),
])
def test_train_cli_config_matches_jax(tmp_path, argv, cfg_file):
    """The CLI's flags over an optional --config file give the same
    TrainConfig in both packages, field by field."""
    import dataclasses

    from tpugs.apps import train as jax_app
    from tpugs_torch.apps import train as torch_app

    if cfg_file is not None:
        path = tmp_path / "c.json"
        path.write_text(json.dumps(cfg_file))
        argv = [str(path) if a == "CFG" else a for a in argv]
    ours = dataclasses.asdict(_cli_config(torch_app, argv))
    ref = dataclasses.asdict(_cli_config(jax_app, argv))
    assert ours == ref


def test_train_cli_config_file_and_resume(scene, tmp_path):
    """--config sets the run, --resume continues it from a checkpoint and
    appends to history.jsonl."""
    out = str(tmp_path / "out")
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "iterations": 4, "log_every": 2, "save_every": 2, "capacity": 128,
        "sh_degree": 1, "densify_mode": "none", "pair_capacity": 16384,
        "max_hits_per_tile": 128}))
    argv = ["-d", scene, "-c", str(cfg), "-o", out, "--device", "cpu"]
    assert torch_train_main(argv) == 0
    assert os.path.exists(os.path.join(out, "ckpt_0000002.npz"))
    assert torch_train_main(argv + ["-i", "6", "--resume",
                                    os.path.join(out, "ckpt_0000004.npz")]) == 0
    hist = [json.loads(x) for x in open(os.path.join(out, "history.jsonl"))]
    assert [h["step"] for h in hist] == [0, 2, 4]
    state, step = load_train_checkpoint(os.path.join(out, "ckpt_0000006.npz"),
                                        "cpu")
    assert step == 6 and int(state.adam.count) == 6

"""The port's Trainer with ADC and MCMC densification against tpugs'
Trainer on one small scene, and the default (ADC) train CLI against the
JAX CLI.

Both Trainers draw the same views; their random draws (split noise,
relocation sources) differ, so losses are compared through an event only
where it draws nothing (clones only, or before the first split or
relocation). Tolerances, with their reasons:
- per-step losses: rtol 1e-4, as tests/test_torch_train.py's Trainer test;
- per-event counts: identical. They decide on avg_grad >= 2e-4, and the
  two packages' accumulated gradients differ (a render gradient through
  another compositor and summation order, and Adam's eps = 1e-15 moving a
  near-zero-gradient element by up to 2 lr): each test asserts as a
  precondition that the packages' avg_grads of the slots near the
  threshold agree within GRAD_RTOL and that no avg_grad lies within
  GRAD_RTOL of the threshold;
- a run split by a checkpoint resume: bit-identical to the straight run.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tpugs.apps.train import main as jax_train_main
from tpugs.optim.densify_adc import ADCConfig as JaxADC
from tpugs.optim.densify_mcmc import MCMCConfig as JaxMCMC
from tpugs.optim.lr_schedule import PositionLRConfig as JaxPLR
from tpugs.train.trainer import TrainConfig as JaxTrainConfig
from tpugs.train.trainer import Trainer as JaxTrainer
from tpugs_torch.apps.train import main as torch_train_main
from tpugs_torch.optim.densify_adc import ADCConfig
from tpugs_torch.optim.densify_mcmc import MCMCConfig
from tpugs_torch.optim.lr_schedule import PositionLRConfig
from tpugs_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_RTOL = 0.02  # 0.011 measured at the two events of the clone run
THRESHOLD = 2e-4
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "s")
    make_scene(root, num_images=10, width=64, height=48, num_points=60)
    return root


def _cfg(cls, out, **kw):
    base = dict(capacity=256, sh_degree=1, log_every=1, save_every=0,
                densify_mode="adc", pair_capacity=1 << 14,
                max_hits_per_tile=128, output_dir=out)
    base.update(kw)
    return cls(**base)


def _adc(cls, **kw):
    return cls(densify_from=10, densify_every=10, densify_until=40,
               opacity_reset_every=20, **kw)


def _record_events(tr, jt, name):
    """Wrap both Trainers' event step `name`: record the state each event
    starts from (the port's as tensors, the reference's as numpy)."""
    seen, jseen = [], []
    ours, ref = getattr(tr, name), getattr(jt, name)

    def record(state, **kw):
        seen.append(state)
        return ours(state, **kw)

    def jrecord(state, **kw):
        jseen.append(jax.tree.map(np.asarray, state))
        return ref(state, **kw)

    setattr(tr, name, record)
    setattr(jt, name, jrecord)
    return seen, jseen


def _assert_grads_clear(seen, jseen):
    """The precondition on avg_grad at every event."""
    assert len(seen) == len(jseen) > 0
    for st, js in zip(seen, jseen):
        avg = (st.adc.grad_accum / torch.clamp(st.adc.grad_count, min=1)).numpy()
        javg = js.adc.grad_accum / np.maximum(js.adc.grad_count, 1)
        alive = js.alive
        near = alive & (np.abs(javg - THRESHOLD) < 2 * THRESHOLD)
        assert near.any()
        rel = np.abs(avg[near] - javg[near]) / javg[near]
        assert rel.max() <= GRAD_RTOL, rel.max()
        gap = np.abs(javg[alive] - THRESHOLD) / THRESHOLD
        assert gap.min() > GRAD_RTOL, gap.min()


def _events(logs):
    return [ln for ln in logs if "densify:" in ln or "opacity reset" in ln
            or "relocate:" in ln]


def _run_both(scene, tmp_path, iters, cfg_kw, event):
    logs, jlogs = [], []
    tr = Trainer(scene, _cfg(TrainConfig, str(tmp_path / "t"), **cfg_kw(False)),
                 log_fn=logs.append, device="cpu")
    jt = JaxTrainer(scene, _cfg(JaxTrainConfig, str(tmp_path / "j"),
                                **cfg_kw(True)), log_fn=jlogs.append)
    seen, jseen = _record_events(tr, jt, event)
    hist, jhist = tr.train(iters), jt.train(iters)
    return (logs, [h["loss"] for h in hist], seen), (
        jlogs, [h["loss"] for h in jhist], jseen)


def test_adc_clone_run_matches_jax(scene, tmp_path):
    """percent_dense so large that every candidate clones, so nothing is
    drawn: losses through two densify events and an opacity reset, and
    the same counts at every event."""
    kw = lambda ref: dict(adc=_adc(JaxADC if ref else ADCConfig,
                                   percent_dense=100.0))
    (logs, losses, seen), (jlogs, jlosses, jseen) = _run_both(
        scene, tmp_path, 30, kw, "_densify")
    _assert_grads_clear(seen, jseen)
    ev = _events(logs)
    assert ev == _events(jlogs)
    assert ev[0].startswith("[10] densify: +") and "+0 split" in ev[0]
    assert ev[1] == "[20] opacity reset" and ev[2].startswith("[20] densify")
    assert " 0 cloned" not in ev[0] + ev[2]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert len(losses) == 30


def test_adc_split_run_matches_jax_to_the_first_event(scene, tmp_path):
    kw = lambda ref: dict(adc=_adc(JaxADC if ref else ADCConfig))
    (logs, losses, seen), (jlogs, jlosses, jseen) = _run_both(
        scene, tmp_path, 12, kw, "_densify")
    _assert_grads_clear(seen, jseen)
    ev = _events(logs)
    assert ev == _events(jlogs) and len(ev) == 1
    assert "+0 split" not in ev[0]
    # The event runs after step 10, so the losses to step 10 are equal.
    np.testing.assert_allclose(losses[:11], jlosses[:11], rtol=LOSS_RTOL)


def test_adc_run_resumed_from_a_checkpoint_is_the_same_run(scene, tmp_path):
    """A run split by a checkpoint resume (the split noise drawn from the
    state's key, the views replayed) ends with the straight run's params,
    bit for bit."""
    kw = dict(log_every=5, save_every=10, adc=_adc(ADCConfig))
    cfg = lambda out: _cfg(TrainConfig, str(tmp_path / out), **kw)
    straight = Trainer(scene, cfg("a"), log_fn=lambda *_: None, device="cpu")
    logs = []
    straight.log = logs.append
    straight.train(30)
    assert any("split" in ln and "+0 split" not in ln for ln in logs)
    first = Trainer(scene, cfg("b"), log_fn=lambda *_: None, device="cpu")
    first.train(20)
    resumed = Trainer(scene, cfg("b"), log_fn=lambda *_: None, device="cpu",
                      resume_from=str(tmp_path / "b" / "ckpt_0000020.npz"))
    resumed.train(30)
    for k in NAMES:
        assert torch.equal(resumed.state.params[k], straight.state.params[k]), k
    assert torch.equal(resumed.state.alive, straight.state.alive)
    assert torch.equal(resumed.state.adc.grad_accum,
                       straight.state.adc.grad_accum)


def test_mcmc_run_matches_jax_to_the_first_event(scene, tmp_path):
    """noise_lr = 0: no noise, so the losses agree until the first
    relocation; its counts agree."""

    def kw(ref):
        m = (JaxMCMC if ref else MCMCConfig)(
            relocate_from=10, relocate_every=10, noise_lr=0.0)
        return dict(densify_mode="mcmc", mcmc=m)

    (logs, losses, _), (jlogs, jlosses, _) = _run_both(
        scene, tmp_path, 12, kw, "_relocate")
    ev = _events(logs)
    assert ev == _events(jlogs) and len(ev) == 1
    assert ev[0].startswith("[10] mcmc relocate: ") and "+0 grown" not in ev[0]
    np.testing.assert_allclose(losses[:11], jlosses[:11], rtol=LOSS_RTOL)


def test_position_lr_sync_warning_matches_jax(scene, tmp_path):
    logs, jlogs = [], []
    cfg = _cfg(TrainConfig, str(tmp_path / "t"), densify_mode="mcmc",
               mcmc=MCMCConfig(position_lr=PositionLRConfig(lr_init=1e-3)))
    jcfg = _cfg(JaxTrainConfig, str(tmp_path / "j"), densify_mode="mcmc",
                mcmc=JaxMCMC(position_lr=JaxPLR(lr_init=1e-3)))
    tr = Trainer(scene, cfg, log_fn=logs.append, device="cpu")
    JaxTrainer(scene, jcfg, log_fn=jlogs.append)
    assert logs[0].startswith("WARNING: MCMCConfig.position_lr")
    assert logs[0] == jlogs[0]
    assert tr.cfg.mcmc.position_lr == tr.cfg.adam.position_lr


def test_default_train_cli_densify_line_matches_jax(scene, tmp_path, capsys):
    """No densify flag: ADC, in both CLIs, with the same densify line."""
    args = ["-d", scene, "-i", "11", "--capacity", "256", "--sh-degree", "1",
            "--log-every", "10", "--save-every", "0", "--pair-capacity",
            "16384", "--max-hits", "128", "--densify-from", "10",
            "--densify-every", "10"]
    assert torch_train_main(args + ["-o", str(tmp_path / "t"),
                                    "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    assert jax_train_main(args + ["-o", str(tmp_path / "j")]) == 0
    ref = capsys.readouterr().out.splitlines()
    line = [ln for ln in ours if "densify:" in ln]
    assert len(line) == 1 and line[0].startswith("[10] densify: +")
    assert line == [ln for ln in ref if "densify:" in ln]
    hist = [json.loads(x) for x in open(os.path.join(tmp_path, "t",
                                                     "history.jsonl"))]
    assert [h["step"] for h in hist] == [0, 10]


def test_overflow_growth_keeps_the_adc_state(scene, tmp_path):
    """A pair overflow in the first block rebuilds the train step with a
    larger capacity: the accumulation goes on in the state, and the first
    event densifies on it."""
    logs, seen = [], []
    tr = Trainer(scene, _cfg(TrainConfig, str(tmp_path / "t"),
                             auto_pair_capacity=False, pair_capacity=128,
                             adc=_adc(ADCConfig)),
                 log_fn=logs.append, device="cpu")
    densify = tr._densify
    tr._densify = lambda state, **kw: (seen.append(state), densify(state, **kw))[1]
    tr.train(11)
    grew = [i for i, ln in enumerate(logs) if "-> growing pair_capacity" in ln]
    event = [i for i, ln in enumerate(logs) if "[10] densify:" in ln]
    assert grew and event and grew[0] < event[0]
    assert tr.raster.pair_capacity > 128
    assert float(seen[0].adc.grad_count.sum()) >= 10 * 20
    assert "+0 split" not in logs[event[0]]

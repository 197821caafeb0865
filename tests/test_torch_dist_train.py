"""The port's Trainer on a data=2,gauss=2 mesh (4 spawned gloo ranks,
tests/torch_dist.py) against tpugs' Trainer on a mesh of 4 of the
conftest's virtual CPU devices, on tests/test_dist_trainer.py's scene
(64x48, tiles of 16, capacity 128, SH 1), and the train and quality CLIs
with --mesh.

Both Trainers draw the same (steps, data rows) view indices; their event
draws differ (parity of the events themselves, with tpugs' draws fed in,
is tests/test_torch_parallel.py's), so losses are compared through events
that draw nothing: an ADC run whose every candidate clones, and an MCMC
run without noise to its first relocation. Tolerances, as
tests/test_torch_densify_train.py's:
- per-step losses rtol 1e-4;
- final params within steps x 2 x the group's lr on >= 99.9% of elements
  (Adam's eps = 1e-15 turns a ulp of a near-zero gradient into a full
  lr step);
- event counts, the alive masks, the interleaved slot layout, the
  exchange's capacity: identical; a resumed mesh run: the straight run,
  bit for bit;
- which clone lands in which free slot of its shard: clones take the free
  slots in the order of their average gradients, which the packages
  compute about 1% apart (GRAD_RTOL of test_torch_densify_train.py), so
  two clones that close may trade slots; final params are therefore held
  to tpugs' shard by shard, each port row against the tpugs row of the
  same shard nearest to it, and the rows that traded are counted.
"""
import json
import os
import re

import jax
import numpy as np
import pytest

from tests.synthetic_scene import make_scene
from tests.torch_dist import run_world
from tpugs.optim.densify_adc import ADCConfig as JaxADC
from tpugs.optim.densify_mcmc import MCMCConfig as JaxMCMC
from tpugs.parallel import dist_train as JDT
from tpugs.parallel.mesh import make_mesh as jax_mesh
from tpugs.train.trainer import TrainConfig as JaxTrainConfig
from tpugs.train.trainer import Trainer as JaxTrainer
from tpugs_torch.io.checkpoint import load_train_checkpoint
from tpugs_torch.optim import adam as TA
from tpugs_torch.parallel.dist_train import mesh_axis_sizes
from tpugs_torch.train.trainer import TrainConfig, Trainer

LOSS_RTOL = 1e-4
MIN_CLOSE = 0.999
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
MESH = "data=2,gauss=2"
BASE = dict(sh_degree=1, capacity=128, save_every=0, log_every=1,
            pair_capacity=1 << 14, max_hits_per_tile=128, tile_h=16,
            tile_w=16, auto_pair_capacity=False, mesh=MESH)
ADC = dict(densify_from=10, densify_every=10, densify_until=40,
           opacity_reset_every=20)
CLONE = dict(ADC, percent_dense=100.0)  # every candidate clones: no draws
MCMC = dict(relocate_from=10, relocate_every=10, noise_lr=0.0)
# Noise at its default noise_lr; the threshold leaves dead gaussians at
# both events, so both relocate.
MCMC_NOISE = dict(relocate_from=10, relocate_every=10,
                  dead_opacity_threshold=0.1)
RUNS = [
    ("clone", dict(BASE, adc=CLONE), 30, None),
    ("mcmc", dict(BASE, densify_mode="mcmc", mcmc=MCMC), 12, None),
    ("mcmc_noise", dict(BASE, densify_mode="mcmc", mcmc=MCMC_NOISE), 21,
     None),
    ("straight", dict(BASE, log_every=5, save_every=10, eval_every=20,
                      adc=ADC, eval=True), 30, None),
    ("first", dict(BASE, log_every=5, save_every=10, eval_every=20,
                   adc=ADC), 20, None),
    ("resumed", dict(BASE, log_every=5, save_every=10, eval_every=20,
                     adc=ADC), 30, "first/ckpt_0000020.npz"),
    ("send", dict(BASE, densify_mode="none", dist_send_capacity=1), 12,
     None),
    ("from_single", dict(BASE, densify_mode="none"), 25,
     "single/ckpt_0000020.npz"),
]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_scene") / "s")
    make_scene(root, num_images=12, width=64, height=48, num_points=80)
    return root


@pytest.fixture(scope="module")
def world(scene, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_runs"))
    single = Trainer(scene, TrainConfig(
        output_dir=os.path.join(out, "single"), densify_mode="none",
        **{k: v for k, v in BASE.items() if k != "mesh"}),
        log_fn=lambda *_: None, device="cpu")
    single.train(20)
    ranks = run_world(4, "tests.torch_dist_cases:trainer_world", out,
                      scene=scene, out=out, runs=RUNS)
    return ranks[0], out, ranks


@pytest.fixture
def jax_mesh_of_4(monkeypatch):
    """tpugs' Trainer on a data x gauss mesh of 4 of the 8 devices."""
    def parse(spec, n_devices=None):
        return jax_mesh(axis_sizes=mesh_axis_sizes(spec, 4),
                        devices=jax.devices()[:4])

    monkeypatch.setattr(JDT, "parse_mesh_spec", parse)


def _jax_run(scene, out, kw, iters):
    kw = dict(kw)
    if "adc" in kw:
        kw["adc"] = JaxADC(**kw["adc"])
    if "mcmc" in kw:
        kw["mcmc"] = JaxMCMC(**kw["mcmc"])
    logs = []
    jt = JaxTrainer(scene, JaxTrainConfig(output_dir=out, **kw),
                    log_fn=logs.append)
    init = jax.tree.map(np.asarray, jt.state)
    hist = jt.train(iters)
    return jt, logs, init, [h["loss"] for h in hist]


def _events(logs):
    return [ln for ln in logs if "densify:" in ln or "opacity reset" in ln
            or "relocate:" in ln]


def _match_rows(a, b, g):
    """Per shard, the row of b nearest (in means) to each row of a; a
    permutation of the shard's rows."""
    n = a.shape[0] // g
    order = []
    for j in range(g):
        sa, sb = a[j * n:(j + 1) * n], b[j * n:(j + 1) * n]
        near = np.argmin(((sa[:, None] - sb[None]) ** 2).sum(-1), axis=1)
        assert len(set(near.tolist())) == n, "rows do not pair up"
        order.append(j * n + near)
    return np.concatenate(order)


def _assert_params_close(p, ref, steps, g=2, max_traded=4):
    lrs = {k: float(v) for k, v in TA.group_lrs(TA.AdamConfig(), 0.0).items()}
    order = _match_rows(p["params/means"], np.asarray(ref["means"]), g)
    traded = int((order != np.arange(order.shape[0])).sum())
    assert traded <= max_traded, traded
    for k in NAMES:
        a, b = p[f"params/{k}"], np.asarray(ref[k])[order]
        assert np.isfinite(a).all()
        close = np.abs(a - b) <= steps * 2 * lrs[k] + 1e-6
        assert close.mean() >= MIN_CLOSE, (k, close.mean())


def test_adc_clone_run_matches_jax(world, scene, tmp_path, jax_mesh_of_4):
    """Losses through two clone-only densify events and an opacity reset,
    the same counts at every event, the same final params."""
    res = world[0]["clone"]
    jt, jlogs, _, jlosses = _jax_run(scene, str(tmp_path), RUNS[0][1], 30)
    ev = _events(res["logs"])
    assert ev == _events(jlogs) and len(ev) == 3
    assert "+0 split" in ev[0] and " 0 cloned" not in ev[0]
    np.testing.assert_allclose(res["losses"], jlosses, rtol=LOSS_RTOL)
    # Falling to the opacity reset at step 20.
    assert len(res["losses"]) == 30 and res["losses"][19] < res["losses"][0]
    _assert_params_close(res["final"], jt.state.params, 30)
    np.testing.assert_array_equal(res["final"]["alive"],
                                  np.asarray(jt.state.alive))


def test_initial_slots_interleaved_and_send_capacity_match_jax(
        world, scene, tmp_path, jax_mesh_of_4):
    res = world[0]["clone"]
    jt = JaxTrainer(scene, JaxTrainConfig(output_dir=str(tmp_path), **{
        k: v for k, v in RUNS[0][1].items() if k != "adc"}),
        log_fn=lambda *_: None)
    alive = res["init"]["alive"]
    np.testing.assert_array_equal(alive, np.asarray(jt.state.alive))
    per_shard = alive.reshape(2, -1).sum(axis=1)
    assert (per_shard == 40).all(), per_shard  # 80 points over 2 shards
    for k in NAMES:
        np.testing.assert_allclose(res["init"][f"params/{k}"],
                                   np.asarray(jt.state.params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    line = [ln for ln in res["logs"] if "auto exchange capacity" in ln]
    assert len(line) == 1 and res["send_capacity"] == jt.cfg.dist_send_capacity
    assert re.search(r"max initial send count \d+ -> 128 slots", line[0])


def test_mcmc_run_matches_jax_to_the_first_relocation(world, scene, tmp_path,
                                                      jax_mesh_of_4):
    res = world[0]["mcmc"]
    _, jlogs, _, jlosses = _jax_run(scene, str(tmp_path), RUNS[1][1], 12)
    ev = _events(res["logs"])
    assert ev == _events(jlogs) and len(ev) == 1
    assert ev[0].startswith("[10] mcmc relocate: ") and "+0 grown" not in ev[0]
    # The relocation follows step 10: the losses to step 10 are the same.
    np.testing.assert_allclose(res["losses"][:11], jlosses[:11],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", ["straight", "mcmc_noise"])
def test_data_rows_hold_identical_states(world, run):
    """The two data rows' replicas of each shard stay bit-identical: the
    per-shard draws (ADC's split noise; MCMC's relocation, growth and
    per-step noise) fold in the gauss index and never the data row. Each
    rank returns its data row's gathered state, so all four agree."""
    ranks = world[2]
    ev = _events(ranks[0][run]["logs"])
    if run == "straight":
        assert any("split" in ln and "+0 split" not in ln for ln in ev)
    else:
        assert len(ev) == 2
        assert all("relocate: 0 of" not in ln for ln in ev), ev
    final = ranks[0][run]["final"]
    for r in (1, 2, 3):
        assert ranks[r][run]["losses"] == ranks[0][run]["losses"]
        for k, v in final.items():
            np.testing.assert_array_equal(ranks[r][run]["final"][k], v,
                                          err_msg=f"rank {r}: {k}")


def test_eval_and_checkpoint_under_the_mesh(world):
    res, out, _ = world
    straight = res["straight"]
    assert any("eval: PSNR" in ln for ln in straight["logs"])
    assert np.isfinite(straight["psnr"]) and straight["psnr"] > 5.0
    for k, v in straight["model"].items():  # gathered on the device
        name = "alive" if k == "alive" else f"params/{k}"
        np.testing.assert_array_equal(v, straight["final"][name], err_msg=k)
    for step in (10, 20, 30):
        assert os.path.exists(os.path.join(out, "straight",
                                           f"ckpt_{step:07d}.npz"))
        assert os.path.exists(os.path.join(out, "straight",
                                           f"model_{step:07d}.ply"))
    hist = [json.loads(x) for x in open(os.path.join(out, "straight",
                                                     "history.jsonl"))]
    assert [h["step"] for h in hist] == [0, 5, 10, 15, 20, 25]


def test_resumed_mesh_run_is_the_straight_run(world):
    res = world[0]
    straight, resumed = res["straight"], res["resumed"]
    assert resumed["start_step"] == 20
    assert any("split" in ln and "+0 split" not in ln
               for ln in straight["logs"])
    for k, v in straight["final"].items():
        np.testing.assert_array_equal(resumed["final"][k], v, err_msg=k)


def test_mesh_checkpoint_loads_on_one_device_and_back(world, scene):
    res, out, _ = world
    state, step = load_train_checkpoint(
        os.path.join(out, "straight", "ckpt_0000030.npz"), "cpu")
    assert step == 30
    for k in NAMES:
        np.testing.assert_array_equal(state.params[k].numpy(),
                                      res["straight"]["final"][f"params/{k}"])
    tr = Trainer(scene, TrainConfig(output_dir=os.path.join(out, "one"),
                                    densify_mode="none", **{
                                        k: v for k, v in BASE.items()
                                        if k != "mesh"}),
                 log_fn=lambda *_: None, device="cpu",
                 resume_from=os.path.join(out, "straight",
                                          "ckpt_0000030.npz"))
    assert tr.start_step == 30 and len(tr.train(32)) == 2
    # The reverse: a one-device checkpoint resumed on the mesh.
    back = res["from_single"]
    assert back["start_step"] == 20 and back["steps"] == [20, 21, 22, 23, 24]
    single, _ = load_train_checkpoint(
        os.path.join(out, "single", "ckpt_0000020.npz"), "cpu")
    for k in NAMES:
        np.testing.assert_array_equal(back["init"][f"params/{k}"],
                                      single.params[k].numpy())


def test_send_capacity_grows_on_overflow(world):
    res = world[0]["send"]
    assert res["send_capacity"] > 1
    assert any("OVERFLOW" in ln and "send_capacity 1->" in ln
               for ln in res["logs"])
    assert np.isfinite(res["losses"]).all()


def test_train_and_quality_clis_with_mesh(scene, tmp_path):
    out = str(tmp_path)
    assert run_world(2, "tests.torch_dist_cases:cli_world", out, scene=scene,
                     out=out) == [(0, 0), (0, 0)]
    assert os.path.exists(os.path.join(out, "train", "ckpt_0000011.npz"))
    hist = [json.loads(x) for x in open(os.path.join(out, "train",
                                                     "history.jsonl"))]
    assert [h["step"] for h in hist] == [0, 10]
    q = json.load(open(os.path.join(out, "quality", "quality.json")))
    assert q["num_images"] == 2 and q["num_gaussians"] > 0

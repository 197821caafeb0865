"""The port's block of K mesh steps (parallel/dist_train.make_dist_multi_step)
on gloo ranks (tests/torch_dist.py), on tests/test_dist_trainer.py's scene
(64x48, tiles of 16, capacity 128, SH 1):

- against tpugs' make_dist_multi_step (K steps in one jitted scan under
  shard_map) on a data=2,gauss=2 mesh of 4 of the conftest's virtual CPU
  devices, from tpugs' mesh Trainer's state three steps in (sharded onto
  the ranks by shard_numpy_state), the same [K, D] view draw, densify
  modes "adc" and "none", the background black: losses within rtol 1e-4,
  parameters by the Trainer rule (steps x 2 x the group's lr on >= 99.9%
  of elements), the ADC accumulators within rtol 1e-4 (counts and radii
  equal), the step statistics equal (the JAX side composites with its
  scan, the port with the kernels' plain versions);
- on a data=1,gauss=2 mesh from the port's mesh Trainer's state: the
  multi-step is K make_dist_train_step calls, bit for bit, for "adc",
  "mcmc" and "none"; the graphed path (graph.BlockRunner replaced by an
  eager stand-in) over two blocks with an event between them (the opacity
  reset for ADC, the relocation otherwise) is the eager multi-step, bit for
  bit, its state the static buffers, MCMC's noise seeded from the key and
  the gauss shard, and it reads nothing to the host (Tensor.item, bool,
  int, float, index and tolist raise outside the kernels' plain
  versions); mesh Trainers whose blocks take the graphed path (densify
  events, an opacity reset, a send-capacity growth that builds a new
  multi-step) end bit-equal to eager ones.
The card's graphed block is tests/test_torch_cuda.py's and chip_smoke.py
phase mesh's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.synthetic_scene import make_scene
from tests.torch_dist import run_world
from tpugs.parallel import dist_train as JDT
from tpugs.parallel.mesh import make_mesh as jax_mesh
from tpugs.train.trainer import TrainConfig as JaxTrainConfig
from tpugs.train.trainer import Trainer as JaxTrainer
from tpugs_torch.core.gaussians import (train_state_from_numpy,
                                        train_state_to_numpy)
from tpugs_torch.optim import adam as TA
from tpugs_torch.parallel import dist_train as DT
from tpugs_torch.parallel.mesh import make_mesh
from tpugs_torch.train import trainer as TT

LOSS_RTOL = 1e-4
ADC_RTOL = 1e-4
MIN_CLOSE = 0.999
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
K, STEP0, DEG = 3, 3, 1
BASE = dict(sh_degree=1, capacity=128, save_every=0, log_every=1,
            pair_capacity=1 << 14, max_hits_per_tile=128, tile_h=16,
            tile_w=16, auto_pair_capacity=False, mesh="data=2,gauss=2")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_ms_scene") / "s")
    make_scene(root, num_images=12, width=64, height=48, num_points=80)
    return root


@pytest.fixture(scope="module")
def jax_world(scene, tmp_path_factory):
    """tpugs' mesh Trainers (one per mode) three steps in, their
    make_dist_multi_step's block of K from that state, and the port's on 4
    gloo ranks from the same state."""
    out = str(tmp_path_factory.mktemp("dist_ms_jax"))
    mp = pytest.MonkeyPatch()
    mp.setattr(JDT, "parse_mesh_spec", lambda spec, n_devices=None: jax_mesh(
        axis_sizes=DT.mesh_axis_sizes(spec, 4), devices=jax.devices()[:4]))
    cases, ref = {}, {}
    try:
        for mode in ("adc", "none"):
            cfg = dict(BASE, densify_mode=mode)
            jt = JaxTrainer(scene, JaxTrainConfig(output_dir=f"{out}/{mode}",
                                                  **cfg),
                            log_fn=lambda *_: None)
            jt.train(STEP0)
            flat = _flat(jt.state)
            vi = np.random.default_rng(1).integers(
                0, jt._views_per_row, size=(K, 2))
            images = np.asarray(jt._image_bank())
            viewmats, intr = np.asarray(jt._viewmats), np.asarray(
                jt._intrinsics)
            raster = {f: getattr(jt.raster, f) for f in (
                "img_h", "img_w", "tile_h", "tile_w", "pair_capacity",
                "max_hits_per_tile")}
            extent = float(jt.scene_extent)
            cfg = {k: v for k, v in cfg.items() if k != "mesh"}
            cfg["dist_send_capacity"] = jt.cfg.dist_send_capacity
            cases[mode] = dict(flat=flat, images=images, viewmats=viewmats,
                               intrinsics=intr, view_idx=vi, step0=STEP0,
                               sh_degree=DEG, cfg=cfg)
            jstate, jlosses, jstats = jt._multi_step(
                jt.state, jt._image_bank(), jt._viewmats, jt._intrinsics,
                jnp.asarray(vi, jnp.int32), jnp.asarray(STEP0, jnp.float32),
                DEG)
            ref[mode] = (jax.tree.map(np.asarray, jstate),
                         np.asarray(jlosses),
                         jax.tree.map(np.asarray, jstats))
    finally:
        mp.undo()
    ranks = run_world(4, "tests.torch_dist_cases:dist_multistep_jax_world",
                      out, cases=cases, raster=raster, extent=extent)
    return ranks, ref


def _flat(jstate) -> dict:
    """tpugs' TrainState as the port's checkpoint-named numpy leaves."""
    n = np.asarray
    flat = {f"params/{k}": n(v) for k, v in jstate.params.items()}
    flat.update({f"adam_m/{k}": n(v) for k, v in jstate.adam.m.items()})
    flat.update({f"adam_v/{k}": n(v) for k, v in jstate.adam.v.items()})
    flat.update(alive=n(jstate.alive), adam_count=n(jstate.adam.count),
                adc_grad_accum=n(jstate.adc.grad_accum),
                adc_grad_count=n(jstate.adc.grad_count),
                adc_max_radii=n(jstate.adc.max_radii),
                key=TT.initial_key(42) + np.asarray([0, STEP0], np.uint32))
    return flat


@pytest.mark.parametrize("mode", ["adc", "none"])
def test_dist_multi_step_matches_jax(jax_world, mode):
    ranks, ref = jax_world
    jstate, jlosses, jstats = ref[mode]
    got = ranks[0][mode]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    for r in ranks[1:]:  # every rank holds the block's losses
        np.testing.assert_array_equal(r[mode]["losses"], got["losses"])
    lrs = {k: float(v) for k, v in
           TA.group_lrs(TA.AdamConfig(), float(STEP0)).items()}
    # Ranks 0 and 2 hold the two data rows' gathered replicas.
    for r in (0, 2):
        state = ranks[r][mode]["state"]
        for name in NAMES:
            a, b = state[f"params/{name}"], jstate.params[name]
            assert np.isfinite(a).all()
            close = np.abs(a - b) <= K * 2 * lrs[name] + 1e-6
            assert close.mean() >= MIN_CLOSE, (r, name, close.mean())
        assert int(state["adam_count"]) == int(jstate.adam.count) == STEP0 + K
        np.testing.assert_array_equal(state["alive"], jstate.alive)
        np.testing.assert_array_equal(state["key"], TT.initial_key(42)
                                      + np.asarray([0, STEP0 + K]))
        if mode == "none":
            assert not state["adc_grad_count"].any()
            continue
        np.testing.assert_array_equal(state["adc_grad_count"],
                                      jstate.adc.grad_count)
        np.testing.assert_array_equal(state["adc_max_radii"],
                                      jstate.adc.max_radii)
        assert state["adc_grad_count"].max() > STEP0
        np.testing.assert_allclose(state["adc_grad_accum"],
                                   jstate.adc.grad_accum, rtol=ADC_RTOL,
                                   atol=1e-9)
    stats = got["stats"]
    for f in ("num_pairs", "max_tile_hits", "max_local_pairs",
              "max_send_count", "pair_overflow", "hit_overflow",
              "send_overflow"):
        assert int(stats[f]) == int(getattr(jstats, f)), f
    assert not stats["send_overflow"] and not stats["pair_overflow"]
    np.testing.assert_allclose(float(stats["loss"]), float(jlosses[-1]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(stats["l1"]), float(jstats.l1),
                               rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def world(scene, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_ms_runs"))
    return run_world(2, "tests.torch_dist_cases:dist_multistep_world", out,
                     scene=scene, out=out)


@pytest.mark.parametrize("mode", ["adc", "mcmc", "none"])
def test_dist_multi_step_is_the_single_steps(world, mode):
    for r in world:
        res = r[f"steps_{mode}"]
        assert res["diffs"] == [] and res["losses_equal"], res
        assert res["stats_equal"] and res["graphed"] == 0, res


@pytest.mark.parametrize("mode", ["adc", "mcmc", "none"])
def test_graphed_dist_bookkeeping_is_the_eager_block(world, mode):
    seeds = []
    for r in world:
        res = r[f"graphed_{mode}"]
        assert res["diffs"] == [] and res["losses_equal"], res
        assert res["stats_equal"] and res["static"], res
        assert res["captures"] == 1 and res["replays"] == 6, res
        if mode == "mcmc":
            assert res["seed"][0] == res["seed"][1], res
            seeds.append(res["seed"][0])
    if mode == "mcmc":  # the two shards draw apart
        assert seeds[0] != seeds[1]


@pytest.mark.parametrize("run", ["adc", "send"])
def test_mesh_trainer_through_the_graphed_block(world, run):
    """The Trainer's blocks through the graphed path: states that events
    or a grown send capacity replaced are copied into the buffers; the run
    is the eager one, bit for bit."""
    for r in world:
        g, e = r[f"trainer_{run}"]["graphed"], r[f"trainer_{run}"]["eager"]
        assert g["losses"] == e["losses"] and len(g["losses"]) == 12
        assert g["replays"] > 0 and e["replays"] == 0
        assert g["send_capacity"] == e["send_capacity"]
        assert g["events"] == e["events"]
        if run == "send":
            assert g["send_capacity"] > 1
        for k, v in e["state"].items():
            np.testing.assert_array_equal(g["state"][k], v, err_msg=k)
    ev = world[0][f"trainer_{run}"]["graphed"]["events"]  # rank 0 logs
    if run == "send":
        assert len(ev) == 1 and "send_capacity 1->" in ev[0], ev
    else:
        assert sum("densify:" in ln for ln in ev) == 2, ev
        assert "+0 split" not in ev[0] and "[8] opacity reset" in ev, ev


def test_dist_reset_opacity_step_is_reset_opacity_step(scene, tmp_path):
    tr = TT.Trainer(scene, TT.TrainConfig(
        output_dir=str(tmp_path), **{k: v for k, v in BASE.items()
                                     if k != "mesh"}),
        log_fn=lambda *_: None, device="cpu")
    mesh = make_mesh((1, 1), device="cpu")
    shard = train_state_from_numpy(DT.shard_numpy_state(
        train_state_to_numpy(tr.state), mesh), "cpu")
    a = train_state_to_numpy(DT.make_dist_reset_opacity_step(mesh)(shard))
    b = train_state_to_numpy(TT.reset_opacity_step(shard))
    for k, v in b.items():
        np.testing.assert_array_equal(a[k], v, err_msg=k)

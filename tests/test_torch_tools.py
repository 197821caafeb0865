"""tpugs_torch's tools against tpugs': profiling (trace, device_time,
StageTimer), the info and dump_points CLIs, the native C++ data layer's
binding (which raises where tpugs falls back), the helpers that no ported
path needed before, the Trainer's memory-watchdog abort, and the new entry
points' refusal to leave the card unasked."""
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tests.test_io import write_cameras_bin, write_images_bin, write_points3d_bin
from tests.torch_parity import np_

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_scene"))
    make_scene(root, num_images=9, width=32, height=24, num_points=40)
    return root


# -- profiling --------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    from tpugs_torch.utils.profiling import trace

    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "t")
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_time_is_positive():
    from tpugs_torch.utils.profiling import device_time

    seen = []

    def step(c, it):
        seen.append(float(it))
        return {"x": c["x"] @ c["x"] * 0.5 + it}

    t = device_time(step, {"x": torch.eye(32)}, k=3, rounds=2)
    assert t > 0
    assert seen == [0.0, 1.0, 2.0] * 3  # a warm-up round and two timed


def test_stage_timer_summary_as_jax(monkeypatch):
    """The same lines as tpugs' StageTimer on the same clock readings."""
    import time

    from tpugs.utils import profiling as JP
    from tpugs_torch.utils import profiling as TP

    out = {}
    for name, mod in (("port", TP), ("jax", JP)):
        ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = mod.StageTimer()
        for stage in ("render", "loss", "render"):
            with t.stage(stage):
                pass
        out[name] = t.summary()
    assert out["port"] == out["jax"]
    assert out["port"].splitlines() == [
        "loss: 0.500s total, 500.0 ms avg x1",
        "render: 0.375s total, 187.5 ms avg x2"]


# -- info, dump_points ------------------------------------------------------

def test_info_cpu_prints_its_json(capsys):
    from tpugs_torch.apps import info

    assert info.main(["--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu" and got["devices"] == []
    assert got["matmul_ok"] is True and got["render_ok"] is True
    assert {"torch_version", "cuda_version", "device_count"} <= set(got)


def test_info_reports_a_failed_smoke_test(monkeypatch, capsys):
    from tpugs_torch.apps import info
    from tpugs_torch.ops import render as render_mod

    def broken(*a, **kw):
        raise ValueError("compositor broke")

    monkeypatch.setattr(render_mod, "render", broken)
    assert info.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert "render smoke: FAIL (ValueError: compositor broke)" in out.out
    assert "compositor broke" in out.err  # the traceback


def test_dump_points_writes_jax_bytes(scene_dir, tmp_path):
    from tpugs.apps.dump_points import main as jax_main
    from tpugs_torch.apps.dump_points import main as torch_main

    assert torch_main(["-d", scene_dir, "-o", str(tmp_path / "p.ply"),
                       "--device", "cpu"]) == 0
    assert jax_main(["-d", scene_dir, "-o", str(tmp_path / "j.ply")]) == 0
    got = (tmp_path / "p.ply").read_bytes()
    assert got == (tmp_path / "j.ply").read_bytes()
    assert b"element vertex 49\n" in got  # 40 points + 9 camera centers


@pytest.mark.parametrize("colors", [True, False])
def test_write_points_ply_matches_jax(tmp_path, colors):
    from tpugs.io.ply import write_points_ply as jax_write
    from tpugs_torch.io.ply import write_points_ply

    rng = np.random.default_rng(3)
    pts, cols = rng.normal(size=(11, 3)), rng.uniform(-0.1, 1.1, (11, 3))
    write_points_ply(tmp_path / "p.ply", pts, cols if colors else None)
    jax_write(tmp_path / "j.ply", pts, cols if colors else None)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("cli", ["viewer", "info", "dump_points"])
def test_new_entry_points_without_cuda_need_device_cpu(cli, monkeypatch,
                                                       scene_dir, tmp_path):
    import importlib

    from tpugs_torch.io.ply import write_gaussian_ply_numpy
    from tpugs_torch.utils.synthetic import synthetic_params_numpy
    from tpugs_torch.viewer.server import ViewerServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ViewerServer, "serve", lambda self, host, port: None)
    p = synthetic_params_numpy(20, seed=0)
    ply = str(tmp_path / "m.ply")
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    argv = {"viewer": ["-m", ply], "info": [],
            "dump_points": ["-d", scene_dir, "-o", str(tmp_path / "d.ply")]}[cli]
    main = importlib.import_module(f"tpugs_torch.apps.{cli}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not (tmp_path / "d.ply").exists()
    assert main(argv + ["--device", "cpu"]) == 0


# -- the native data layer --------------------------------------------------

def _fixtures(tmp_path):
    rng = np.random.default_rng(0)
    pts = [(i, rng.normal(size=3), rng.integers(0, 256, 3), 0.5,
            [(1, 2)] * int(rng.integers(0, 4))) for i in range(50)]
    write_points3d_bin(str(tmp_path / "points3D.bin"), pts)
    write_cameras_bin(str(tmp_path / "cameras.bin"), [
        (1, 1, 640, 480, [500.0, 510.0, 320.0, 240.0]),
        (2, 0, 100, 100, [80.0, 50.0, 50.0]),
        (5, 4, 64, 48, [60.0, 61.0, 32.0, 24.0, 0.1, 0.2, 0.3, 0.4])])
    write_images_bin(str(tmp_path / "images.bin"), [
        (7, [1, 0, 0, 0], [0.5, -1.0, 2.0], 1, "a_photo.png", [(1.0, 2.0, 3)]),
        (9, [0.7, 0.7, 0, 0], [1, 2, 3], 2, "z.png", [])])
    return str(tmp_path)


def _parse_all(mod, sparse):
    cams, images, xyz, rgb = mod.parse_colmap_sparse(sparse)
    return ({k: (c.camera_id, int(c.model), c.width, c.height, list(c.params))
             for k, c in cams.items()},
            [(i.image_id, list(i.qvec), list(i.tvec), i.camera_id, i.name)
             for i in images], xyz, rgb)


def test_native_parse_matches_numpy_and_jax(tmp_path, monkeypatch):
    """The native parsers (the default), the port's numpy parsers
    (TPUGS_NATIVE=0's path) and tpugs' numpy parsers read the same."""
    import tpugs.data.colmap as JC
    from tpugs_torch.data import colmap as TC

    sparse = _fixtures(tmp_path)
    assert TC.USE_NATIVE
    native = _parse_all(TC, sparse)
    monkeypatch.setattr(TC, "USE_NATIVE", False)
    numpy_ = _parse_all(TC, sparse)
    monkeypatch.setattr(JC, "USE_NATIVE", False)
    ref = _parse_all(JC, sparse)
    for got in (native, numpy_):
        assert got[0] == ref[0] and got[1] == ref[1]
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])
        assert got[2].dtype == np.float64 and got[3].dtype == np.uint8


def test_native_gaussian_ply_is_the_numpy_bytes(tmp_path):
    from tpugs.io.ply import write_gaussian_ply_numpy as jax_write
    from tpugs_torch.io.ply import (read_gaussian_ply, write_gaussian_ply,
                                    write_gaussian_ply_numpy)

    rng = np.random.default_rng(1)
    n, c = 7, 4
    arrs = (rng.normal(size=(n, 3)), rng.normal(size=(n, 3, c)),
            rng.normal(size=(n,)), rng.normal(size=(n, 3)),
            rng.normal(size=(n, 4)))
    arrs = [a.astype(np.float32) for a in arrs]
    write_gaussian_ply(str(tmp_path / "nat.ply"), *arrs)
    write_gaussian_ply_numpy(str(tmp_path / "py.ply"), *arrs)
    jax_write(str(tmp_path / "jax.ply"), *arrs)
    nat = (tmp_path / "nat.ply").read_bytes()
    assert nat == (tmp_path / "py.ply").read_bytes()
    assert nat == (tmp_path / "jax.ply").read_bytes()
    back = read_gaussian_ply(str(tmp_path / "nat.ply"))
    np.testing.assert_array_equal(back["sh"], arrs[1])


def test_native_library_builds_into_the_port(tmp_path):
    from tpugs_torch.data import native

    path = native.library_path(native.SOURCE)
    native.lib()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert native.SOURCE.parent.name == "native"


@pytest.mark.parametrize("case", ["missing", "broken"])
def test_native_raises_where_it_cannot_build(case, tmp_path, monkeypatch):
    """Asked for and not buildable, the native path raises (never falls
    back in silence): a missing source, and one g++ refuses."""
    from tpugs_torch.data import colmap as TC
    from tpugs_torch.data import native
    from tpugs_torch.io.ply import write_gaussian_ply

    src = tmp_path / "colmap_io.cpp"
    if case == "broken":
        src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    match = "not found" if case == "missing" else "g\\+\\+ failed"
    sparse = _fixtures(tmp_path)
    with pytest.raises(native.NativeUnavailable, match=match):
        TC.parse_points3d_bin(os.path.join(sparse, "points3D.bin"))
    z = np.zeros((2, 3), np.float32)
    with pytest.raises(native.NativeUnavailable, match=match):
        write_gaussian_ply(str(tmp_path / "m.ply"), z, np.zeros((2, 3, 1)),
                           np.zeros(2), z, np.zeros((2, 4)))
    assert not (tmp_path / "m.ply").exists()
    monkeypatch.setattr(TC, "USE_NATIVE", False)  # the opt-out still reads
    assert TC.parse_points3d_bin(os.path.join(sparse, "points3D.bin"))[0].shape \
        == (50, 3)


def test_native_parse_of_a_malformed_file_raises(tmp_path):
    from tpugs_torch.data import native

    (tmp_path / "points3D.bin").write_bytes(b"\x05" + b"\x00" * 7 + b"\x01")
    with pytest.raises(OSError, match="malformed"):
        native.parse_points3d(str(tmp_path / "points3D.bin"))


# -- helpers ----------------------------------------------------------------

def test_gaussian_state_helpers_match_jax():
    from tpugs.core.gaussians import GaussianState as JaxState
    from tpugs_torch.core.gaussians import PARAM_NAMES, GaussianState

    rng = np.random.default_rng(0)
    arrs = dict(means=rng.normal(size=(5, 3)), quats=rng.normal(size=(5, 4)),
                log_scales=rng.normal(size=(5, 3)),
                opacity_logits=rng.normal(size=5),
                sh=rng.normal(size=(5, 3, 9)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    got = GaussianState.create(*[arrs[k] for k in PARAM_NAMES], capacity=8,
                               device="cpu")
    ref = JaxState.create(*[jnp.asarray(arrs[k]) for k in PARAM_NAMES],
                          capacity=8)
    assert got.max_sh_degree == ref.max_sh_degree == 2
    assert int(got.num_alive()) == int(ref.num_alive()) == 5
    assert got.num_alive().dtype == torch.int32
    new = {k: torch.full_like(v, 2.0) for k, v in got.params().items()}
    rep = got.replace_params(new)
    jrep = ref.replace_params({k: jnp.full_like(v, 2.0)
                               for k, v in ref.params().items()})
    for k in PARAM_NAMES + ("alive",):
        np.testing.assert_array_equal(np_(getattr(rep, k)),
                                      np_(getattr(jrep, k)), err_msg=k)
    for deg in (0, 3):
        e, je = GaussianState.empty(6, deg, device="cpu"), JaxState.empty(6, deg)
        for k in PARAM_NAMES + ("alive",):
            np.testing.assert_array_equal(np_(getattr(e, k)),
                                          np_(getattr(je, k)), err_msg=k)
            assert np_(getattr(e, k)).dtype == np_(getattr(je, k)).dtype, k
        assert e.max_sh_degree == deg


def test_sh_dc_to_rgb_and_resize_image_match_jax():
    from tpugs.core import sh as JS
    from tpugs.data.image_io import resize_image as jax_resize
    from tpugs_torch.core import sh as TS
    from tpugs_torch.data.image_io import resize_image

    rng = np.random.default_rng(0)
    dc = rng.normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_(TS.sh_dc_to_rgb(torch.from_numpy(dc))),
                                  np_(JS.sh_dc_to_rgb(jnp.asarray(dc))))
    rgb = torch.from_numpy(rng.uniform(size=(10, 3)).astype(np.float32))
    np.testing.assert_allclose(np_(TS.sh_dc_to_rgb(TS.rgb_to_sh_dc(rgb))),
                               np_(rgb), atol=1e-6)
    img = rng.uniform(-0.1, 1.1, (24, 32, 3)).astype(np.float32)
    for w, h in ((16, 12), (45, 30)):
        got = resize_image(img, w, h)
        assert got.shape == (h, w, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_resize(img, w, h))


def test_sparse_point_and_synthetic_intrinsics_match_jax():
    import dataclasses

    from tpugs.data.colmap import SparsePoint as JaxPoint
    from tpugs.utils.synthetic import synthetic_intrinsics as jax_intr
    from tpugs_torch.data.colmap import SparsePoint
    from tpugs_torch.utils.synthetic import synthetic_intrinsics

    assert ([f.name for f in dataclasses.fields(SparsePoint)]
            == [f.name for f in dataclasses.fields(JaxPoint)])
    pt = SparsePoint(np.zeros(3), np.zeros(3, np.uint8))
    assert pt.rgb.dtype == np.uint8
    got = synthetic_intrinsics(96, 64, 50.0)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(np_(got), np_(jax_intr(96, 64, 50.0)))


def test_max_pairs_per_tile_matches_jax():
    from tests.torch_parity import random_projection, torch_projection
    from tpugs.ops import binning as JB
    from tpugs.ops.projection import ProjectionOutput as JaxProjection
    from tpugs_torch.ops import binning as TB

    proj = random_projection(80, 64, 48, 1)
    got = TB.bin_gaussians(torch_projection(proj), 64, 48, 16, 16, 4096)
    ref = JB.bin_gaussians(JaxProjection(**{k: jnp.asarray(v)
                                            for k, v in proj.items()}),
                           64, 48, 16, 16, 4096)
    assert int(TB.max_pairs_per_tile(got)) == int(JB.max_pairs_per_tile(ref))
    assert int(TB.max_pairs_per_tile(got)) > 1


# -- the Trainer's watchdog -------------------------------------------------

def test_trainer_watchdog_aborts_with_a_checkpoint(scene_dir, tmp_path):
    """tests/test_watchdog.py's abort on the port's Trainer: a budget every
    reading exceeds; training returns, a checkpoint is written before the
    last step, and the log says it is aborting."""
    from tpugs_torch.train.trainer import TrainConfig, Trainer
    from tpugs_torch.utils.memory import MemoryWatchdog

    out = str(tmp_path / "wd")
    cfg = TrainConfig(iterations=100, sh_degree=0, capacity=128, save_every=0,
                      log_every=5, steps_per_call=5, tile_h=16, tile_w=16,
                      pair_capacity=1 << 14, auto_pair_capacity=False,
                      max_hits_per_tile=128, densify_mode="none",
                      output_dir=out)
    logs = []
    t = Trainer(scene_dir, cfg, log_fn=logs.append, device="cpu")
    mb = 1024 * 1024
    t.watchdog = MemoryWatchdog(limit_mb=1.0, max_critical_streak=2,
                                stats_fn=lambda: {"bytes_in_use": 10 * mb},
                                log=logs.append)
    t.train()  # returns, does not raise
    steps = [int(f[5:-4]) for f in os.listdir(out)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    assert steps and max(steps) < 100
    assert os.path.exists(os.path.join(out, f"model_{max(steps):07d}.ply"))
    assert any("aborting" in str(m) for m in logs)
    assert sum("HBM CRITICAL" in str(m) for m in logs) == 2
    assert re.search(r"\[5\] HBM over limit 2 consecutive", "\n".join(
        str(m) for m in logs))

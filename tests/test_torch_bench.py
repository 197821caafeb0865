"""The port's benchmark (tpugs_torch/bench.py, root bench_torch.py) against
bench.py on the CPU at small shapes: its bare train step against the JAX
step that bench.py builds (tpugs' render on its Pallas branch in interpret
mode, combined_loss(..., 0.2), jax.value_and_grad, adam_step), fed the same
numpy params and target; carry on against carry off; the two overflow
asserts with bench.py's messages; the JSON line with bench.py's keys and
shapes; and no fallback from the card to the CPU.

Tolerances, with their reasons (the parity rules of the Trainer tests):
per-step losses rtol 1e-4; final params within steps x 2 x the group's lr
on >= 99.9% of elements, since Adam's eps = 1e-15 turns a ulp-level
difference in a gradient near zero into a full lr-sized step. Carry on
against carry off: bit for bit (the same pairs in the same order).
"""
import ast
import io
import json
import os
import pathlib
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import np_
from tpugs.ops.render import RasterConfig as JaxConfig
from tpugs.ops.render import render as jax_render
from tpugs.optim import adam as JA
from tpugs.train.loss import combined_loss as jax_combined_loss
from tpugs.utils.synthetic import synthetic_intrinsics as jax_intrinsics
from tpugs.utils.synthetic import synthetic_params as jax_params
from tpugs_torch import bench
from tpugs_torch.ops import expand as expand_mod
from tpugs_torch.ops import render as render_mod
from tpugs_torch.ops.render import RasterConfig
from tpugs_torch.optim import adam as TA

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = bench.NAMES
LOSS_RTOL = 1e-4
MIN_CLOSE = 0.999
W, H, N, CAP, HITS, K = 96, 64, 300, 16384, 512, 3


def _jax_run(k: int, target: np.ndarray, presort="auto", carry=False):
    """bench.py's train_step (bench.py:54-64) for k steps at schedule steps
    arange(k), on its scene; returns (params, per-step losses)."""
    cfg = JaxConfig(img_h=H, img_w=W, tile_h=32, tile_w=32, pair_capacity=CAP,
                    max_hits_per_tile=HITS)
    params = jax_params(N, seed=0)
    alive = jnp.ones((N,), bool)
    viewmat = jnp.eye(4)
    intr = jax_intrinsics(W, H)
    bg = jnp.zeros((3,))
    adam_state = JA.adam_init(params)
    tgt = jnp.asarray(target)

    @jax.jit
    def train_step(params, adam_state, step):
        def loss_fn(p):
            out = jax_render(
                p["means"], p["quats"], p["log_scales"], p["opacity_logits"],
                p["sh"], alive, viewmat, intr, cfg, 3, bg, carry_attrs=carry,
                compositor="pallas", presort=presort)
            return jax_combined_loss(out.color, tgt, 0.2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, adam_state = JA.adam_step(JA.AdamConfig(), adam_state, params,
                                          grads, step)
        return params, adam_state, loss

    losses = []
    for step in jnp.arange(k, dtype=jnp.float32):
        params, adam_state, loss = train_step(params, adam_state, step)
        losses.append(float(loss))
    return params, np.asarray(losses)


def _port_run(k: int, target: np.ndarray, carry=False):
    """The port's bench step (make_bench_step + run_k) for k steps on the
    same scene and target, on the CPU; returns (params, losses, adam)."""
    cfg = RasterConfig(img_h=H, img_w=W, tile_h=32, tile_w=32,
                       pair_capacity=CAP, max_hits_per_tile=HITS)
    params, alive, viewmat, intr, bg = bench.bench_scene(W, H, N)
    step = bench.make_bench_step(cfg, alive, viewmat, intr, bg,
                                 torch.from_numpy(target), carry)
    params, adam, losses = bench.run_k(step, params, TA.adam_init(params),
                                       0.0, k)
    return params, np_(losses), adam


@pytest.mark.parametrize("sort", ["exact-presort", "two-key"])
def test_bench_step_matches_jax(monkeypatch, sort):
    """k steps of the port's bench step against bench.py's JAX step. The
    default ("auto") takes the exact presort below 2^18 gaussians, as the
    50k shape does; "two-key" lowers the port's threshold and hands tpugs
    presort=False, the branch "auto" takes at the garden shape's 1M."""
    target = bench.bench_target(W, H).numpy()
    presort = "auto"
    if sort == "two-key":
        monkeypatch.setattr(render_mod, "PRESORT_MAX_N", 0)
        presort = False
    jparams, jlosses = _jax_run(K, target, presort=presort)
    params, losses, adam = _port_run(K, target)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert int(adam.count) == K
    lrs = {k: float(v) for k, v in TA.group_lrs(TA.AdamConfig(), 0.0).items()}
    for name in NAMES:
        a, b = np_(params[name]), np.asarray(jparams[name])
        assert np.isfinite(a).all(), name
        close = np.abs(a - b) <= K * 2 * lrs[name] + 1e-6
        assert close.mean() >= MIN_CLOSE, (name, close.mean())


def test_bench_target_and_scene_are_the_numpy_draws():
    """The target is default_rng(0)'s float32 uniform image and the scene
    tpugs' synthetic_params / synthetic_intrinsics, value for value."""
    t = bench.bench_target(W, H)
    assert t.shape == (H, W, 3) and t.dtype == torch.float32
    np.testing.assert_array_equal(
        t.numpy(), np.random.default_rng(0).random((H, W, 3), dtype=np.float32))
    params, alive, viewmat, intr, bg = bench.bench_scene(
        W, H, N, scale_range=(0.002, 0.015))
    ref = jax_params(N, seed=0, scale_range=(0.002, 0.015))
    for name in NAMES:
        np.testing.assert_array_equal(np_(params[name]), np.asarray(ref[name]))
    np.testing.assert_array_equal(np_(intr), np.asarray(jax_intrinsics(W, H)))
    assert bool(alive.all()) and torch.equal(viewmat, torch.eye(4))
    assert not bg.any()


def test_carry_on_equals_carry_off_bit_for_bit(monkeypatch):
    """TPUGS_TRAIN_CARRY's mode: the same losses, parameters and moments
    over k steps; each carried step expands in carry mode (with the
    attribute table), each other step without."""
    modes = []
    orig = expand_mod.expand_pairs

    def recorder(*args, **kw):
        modes.append(len(args) > 7 and args[7] is not None)
        return orig(*args, **kw)

    monkeypatch.setattr(expand_mod, "expand_pairs", recorder)
    target = bench.bench_target(W, H).numpy()
    p0, l0, a0 = _port_run(K, target, carry=False)
    p1, l1, a1 = _port_run(K, target, carry=True)
    assert modes == [False] * K + [True] * K
    np.testing.assert_array_equal(l0, l1)
    for name in NAMES:
        assert torch.equal(p0[name], p1[name]), name
        assert torch.equal(a0.m[name], a1.m[name]), name
        assert torch.equal(a0.v[name], a1.v[name]), name


def test_carry_knob_is_read_as_bench_py_reads_it(monkeypatch):
    monkeypatch.delenv("TPUGS_TRAIN_CARRY", raising=False)
    assert bench.carry_knob() is False
    for value, want in (("1", True), ("0", False), ("true", False)):
        monkeypatch.setenv("TPUGS_TRAIN_CARRY", value)
        assert bench.carry_knob() is want


def test_measure_config_runs_the_bench_step_on_the_cpu():
    """measure_config's (rounds + 1) k losses are those of run_k over the
    same schedule; its rate is rounds k steps over its seconds."""
    k, rounds = 2, 2
    m = bench.measure_config(W, H, N, CAP, HITS, k=k, rounds=rounds,
                             device="cpu", carry=False)
    _, losses, _ = _port_run(k * (rounds + 1), bench.bench_target(W, H).numpy())
    np.testing.assert_array_equal(m.losses, losses)
    assert m.seconds > 0 and np.isclose(m.its, rounds * k / m.seconds)
    assert np.isclose(m.mpix_s, m.its * W * H / 1e6)
    assert 0 < m.num_pairs <= CAP and 0 < m.max_tile_hits <= HITS


@pytest.mark.parametrize("cap,hits,message", [
    (64, HITS, r"^pair capacity 64 overflowed \(\d+ pairs\)$"),
    (CAP, 16, r"^max_hits 16 overflowed \(\d+ in busiest tile\)$"),
])
def test_overflow_asserts_fire_with_bench_py_messages(cap, hits, message):
    with pytest.raises(AssertionError, match=message):
        bench.measure_config(W, H, N, cap, hits, k=1, rounds=1, device="cpu")


def _bench_py_calls() -> list[dict]:
    """bench.py's measure_config calls, as keyword dicts with its defaults
    (k=10, rounds=3) filled in."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "measure_config"):
            kw = dict(zip(("img_w", "img_h", "n"),
                          (ast.literal_eval(a) for a in node.args)))
            kw.update({a.arg: ast.literal_eval(a.value) for a in node.keywords})
            calls.append({"k": 10, "rounds": 3, **kw})
    return calls


@pytest.mark.parametrize("skip", ["0", "1"])
def test_main_prints_bench_py_line(monkeypatch, skip):
    """One JSON line with bench.py's keys and names, at bench.py's shapes;
    TPUGS_BENCH_SKIP_GARDEN=1 skips the second shape."""
    calls = []

    def fake(**kw):
        calls.append({"k": 10, "rounds": 3, **kw})
        its = 2.0 if kw["n"] == 50_000 else 0.5
        return bench.Measured(mpix_s=its * kw["img_w"] * kw["img_h"] / 1e6,
                              its=its, seconds=1.0, losses=np.zeros(1),
                              num_pairs=1, max_tile_hits=1)

    monkeypatch.setattr(bench, "measure_config", fake)
    monkeypatch.setenv("TPUGS_BENCH_SKIP_GARDEN", skip)
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench.main() == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"] == "train_step_throughput_50k_sh3_489x272"
    assert line["unit"] == "Mpix/s (fwd+bwd+adam)"
    assert line["value"] == round(2.0 * 489 * 272 / 1e6, 4)
    assert line["vs_baseline"] == 5.0  # 2 it/s against the reference's 0.4
    want = _bench_py_calls()
    if skip == "1":
        assert line["extra"] == {"garden": "skipped"}
        assert calls == want[:1]
    else:
        assert line["extra"] == {"garden30k_shape_1297x840_1M_sh3": {
            "value": round(0.5 * 1297 * 840 / 1e6, 4),
            "unit": "Mpix/s (fwd+bwd+adam)", "it_per_s": 0.5}}
        assert calls == want and len(want) == 2


def test_main_without_cuda_raises(monkeypatch):
    """No fallback: main() asks for the card and raises resolve_device's
    error where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


def test_bench_torch_script_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""

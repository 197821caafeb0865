"""Guards of the port: it imports nothing of JAX or tpugs, its entry points
refuse to fall back to the CPU, its kernel wrappers send CPU tensors to the
plain versions and never swallow an error, its build raises with nvcc's
message, what is not yet ported raises instead of doing nothing, and a
mesh uses the backend of its device unless one is named."""
import ast
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpugs_torch import cuda_lib
from tpugs_torch.apps import render as render_app
from tpugs_torch.device import resolve_device
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops import composite_t, expand, pack, segreduce
from tpugs_torch.ops.rasterize_tiled import RasterConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tpugs_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpugs")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "bench_torch.py"]


def _modules():
    return sorted(
        "tpugs_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    ) + ["tpugs_torch"]


def test_sources_import_no_jax_or_tpugs():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: {name}"


def test_every_module_imports_with_jax_and_tpugs_blocked():
    code = (
        "import sys, py_compile, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'tpugs'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"for f in {[str(ROOT / f) for f in ('chip_smoke.py', 'bench_torch.py')]!r}:\n"
        "    py_compile.compile(f, doraise=True, cfile=None)\n"
        "import chip_smoke, bench_torch\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_device_resolution_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _make_gt_model(tmp_path, **kw):
    from tpugs_torch.utils.gt_scene import make_gt_model

    return make_gt_model(20, **kw)


def _init_from_sfm(tmp_path, **kw):
    from tpugs_torch.core.init import init_from_sfm

    pts = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    return init_from_sfm(pts, np.full((8, 3), 0.5, np.float32), 16, **kw)


def _create(tmp_path, **kw):
    from tpugs_torch.core.gaussians import GaussianState

    z = torch.zeros
    return GaussianState.create(z(4, 3), z(4, 4), z(4, 3), z(4), z(4, 3, 1),
                                **kw)


def _adc_init(tmp_path, **kw):
    from tpugs_torch.optim.densify_adc import adc_init

    return adc_init(8, **kw)


def _event_generator(tmp_path, **kw):
    from tpugs_torch.train.trainer import DENSIFY_STREAM, event_generator

    return event_generator(np.zeros(2, np.uint32), DENSIFY_STREAM, **kw)


def _eval_views(tmp_path, **kw):
    from tpugs_torch.data.dataset import Dataset
    from tpugs_torch.train.trainer import eval_views

    root, _ = _train_scene(tmp_path)
    return eval_views(Dataset(root), **kw)


def _train_state(tmp_path, **kw):
    from tpugs_torch.core.gaussians import train_state_from_numpy

    z = np.zeros
    flat = {f"{g}/{k}": z(s, np.float32) for g in ("params", "adam_m", "adam_v")
            for k, s in (("means", (4, 3)), ("quats", (4, 4)),
                         ("log_scales", (4, 3)), ("opacity_logits", (4,)),
                         ("sh", (4, 3, 1)))}
    flat.update(alive=z(4, bool), adam_count=np.int32(0),
                key=z(2, np.uint32), adc_grad_accum=z(4, np.float32),
                adc_grad_count=z(4, np.float32), adc_max_radii=z(4, np.float32))
    return train_state_from_numpy(flat, **kw)


def _tensors(out):
    """The tensors and generators in out, one level into containers."""
    if isinstance(out, (torch.Tensor, torch.Generator)):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _tensors(v)]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _tensors(v)]
    if hasattr(out, "__dict__"):
        return [t for v in vars(out).values() for t in _tensors(v)]
    return []


def _load_checkpoint(tmp_path, **kw):
    from tpugs_torch.io.checkpoint import (load_train_checkpoint,
                                           save_train_checkpoint)
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.train.trainer import TrainState, initial_key

    gs = _create(tmp_path, device="cpu")
    state = TrainState(params=gs.params(), alive=gs.alive,
                       adam=adam_init(gs.params()),
                       adc=_adc_init(tmp_path, device="cpu"), key=initial_key(0))
    path = str(tmp_path / "c.npz")
    save_train_checkpoint(path, state, 3)
    return load_train_checkpoint(path, **kw)[0]


@pytest.mark.parametrize("make", [_make_gt_model, _init_from_sfm, _create,
                                  _adc_init, _load_checkpoint, _train_state,
                                  _event_generator, _eval_views])
def test_state_helpers_default_to_the_card(make, monkeypatch, tmp_path):
    """The helpers that put model or train state, the densify and relocate
    events' generators or the evaluation's views on a device take the card
    unless the CPU is asked for, as the entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(tmp_path)
    tensors = _tensors(make(tmp_path, device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_cli_without_cuda_needs_device_cpu(monkeypatch, tmp_path):
    from tpugs_torch.io.ply import write_gaussian_ply_numpy
    from tpugs_torch.utils.synthetic import synthetic_params_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = synthetic_params_numpy(20, seed=0)
    ply = tmp_path / "m.ply"
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    argv = ["-m", str(ply), "-o", str(tmp_path / "f"), "--frames", "1",
            "--width", "32", "--height", "32"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_app.main(argv)
    assert not (tmp_path / "f").exists()
    assert render_app.main(argv + ["--device", "cpu"]) == 0
    assert (tmp_path / "f" / "frame_0000.png").exists()


def _expand_args(device="cpu"):
    from tests.torch_parity import random_projection, torch_projection

    tp = torch_projection(random_projection(50, 64, 48, 0))
    ex = TB.expand_inputs(tp, 64, 48, 16, 16, 4096)
    return (ex.itab.to(device), ex.ftab.to(device), ex.p_out, ex.num_tiles,
            ex.ntx, 16, 16)


def _wrappers(device="cpu"):
    """(name, call, counter, (module, plain name)) for each kernel; call()
    runs its wrapper, counter() reads the wrapper's count of its launches."""
    cfg = RasterConfig(img_h=48, img_w=64, tile_h=16, tile_w=16)
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=device)
    i32 = torch.int32
    ex = _expand_args(device)
    bwd = (cfg, z(12, dt=i32), z(12, dt=i32), z(16, 128), z(12, 256, 3),
           z(12, 256), z(12, 256), z(12, 256, dt=i32))
    cb = composite_t.composite_backward
    return [
        ("expand", lambda: expand.expand_pairs(*ex),
         lambda: expand.expand_pairs.launches, (expand, "expand_pairs_plain")),
        ("expand carry", lambda: expand.expand_pairs(*ex, z(9, ex[0].shape[1])),
         lambda: expand.expand_pairs.launches_carry,
         (expand, "expand_pairs_plain")),
        ("align_copy", lambda: pack.align_copy(
            z(16, 256), z(12, dt=i32), z(12, dt=i32), z(12, dt=i32), 128),
         lambda: pack.align_copy.launches, (pack, "align_copy_plain")),
        ("composite_fwd", lambda: composite_t.composite_forward(
            cfg, z(12, dt=i32), z(12, dt=i32), z(16, 128)),
         lambda: composite_t.composite_forward.launches,
         (composite_t, "composite_forward_plain")),
        ("composite_bwd", lambda: cb(*bwd), lambda: cb.launches,
         (composite_t, "composite_backward_plain")),
        ("composite_bwd entry-major", lambda: cb(*bwd, transposed_out=False),
         lambda: cb.launches_entry_major,
         (composite_t, "composite_backward_plain")),
        ("segreduce_sorted", lambda: segreduce.segment_sum_sorted(
            z(9, 64), z(5, dt=i32), 4),
         lambda: segreduce.segment_sum_sorted.launches,
         (segreduce, "segment_sum_sorted_plain")),
        ("segreduce_interval", lambda: segreduce.segment_reduce(
            z(64, 9), z(4, dt=i32), z(4, dt=i32), 64, 4),
         lambda: segreduce.segment_reduce.launches,
         (segreduce, "segment_reduce_plain")),
    ]


@pytest.mark.parametrize("k", range(8))
def test_cpu_tensor_reaches_the_plain_version(monkeypatch, k):
    _, call, counter, (mod, plain) = _wrappers()[k]
    before = counter()
    monkeypatch.setattr(mod, plain, lambda *a, **kw: "plain")
    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("kernel launched"))
    assert call() == "plain"
    assert counter() == before


@pytest.mark.parametrize("k", range(8))
def test_non_cpu_tensor_goes_to_the_kernel_and_errors_propagate(monkeypatch, k):
    """A tensor off the CPU never takes the plain version: the wrapper goes
    to the kernel library, and its failure reaches the caller."""
    _, call, counter, (mod, plain) = _wrappers("meta")[k]
    monkeypatch.setattr(mod, plain, lambda *a, **kw: pytest.fail("fell back"))

    def broken():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(cuda_lib, "lib", broken)
    before = counter()
    with pytest.raises(RuntimeError, match="no kernel library"):
        call()
    assert counter() == before


def test_wrapper_rejects_wrong_inputs():
    itab, ftab, *rest = _expand_args("meta")
    with pytest.raises(ValueError, match="dtype"):
        expand.expand_pairs(itab.float(), ftab, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        expand.expand_pairs(itab, ftab.t().contiguous().t(), *rest)
    with pytest.raises(ValueError, match="expected"):
        expand.expand_pairs(itab[:4].contiguous(), ftab, *rest)
    with pytest.raises(ValueError, match="atab"):
        expand.expand_pairs(itab, ftab, *rest, torch.zeros(9, 3, device="meta"))
    rows = torch.zeros(64, 9, device="meta")
    iv = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected"):
        segreduce.segment_reduce(rows[:, :8].contiguous(), iv, iv, 64, 4)
    with pytest.raises(ValueError, match="exp_end"):
        segreduce.segment_reduce(rows, iv, iv, 65, 4)


@pytest.mark.parametrize("k,name,what", [
    (0, "tpugs_align_copy", "tile 6 has a segment"),
    (1, "tpugs_segreduce_interval", "gaussian 6 has an interval"),
])
def test_guard_word_raises_before_the_next_launch(monkeypatch, k, name, what):
    """A kernel that finds its inputs out of contract sets its guard word
    (mapped host memory, here a plain array): the library raises on it
    before the next launch, names the kernel and the item, and clears it."""
    words = (ctypes.c_int * len(cuda_lib.GUARDED))()
    monkeypatch.setattr(cuda_lib, "_guard_host", words)
    monkeypatch.setattr(cuda_lib, "_lib", "loaded")
    assert list(cuda_lib.GUARDED)[k] == name
    assert cuda_lib.lib() == "loaded"
    words[k] = 7
    with pytest.raises(ValueError, match=f"{name}: .*{what}"):
        cuda_lib.lib()
    assert list(words) == [0] * len(cuda_lib.GUARDED)
    assert cuda_lib.lib() == "loaded"
    words[k] = 7
    with pytest.raises(ValueError, match=what):
        cuda_lib.check_guards()
    cuda_lib.check_guards()


def test_launch_error_code_raises():
    cuda_lib.check("tpugs_expand", 0)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        cuda_lib.check("tpugs_expand", 9)


def test_build_failure_raises_with_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda_lib.build()
    assert not cuda_lib.library_path().exists()


def test_build_command_and_key():
    srcs = cuda_lib.sources()
    assert {s.name for s in srcs} == {"expand.cu", "align_copy.cu",
                                      "composite_fwd.cu", "composite_bwd.cu",
                                      "segreduce.cu", "guard_words.cu"}
    for s in srcs:
        text = s.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text
        if s.name != "guard_words.cu":  # the guard words' allocator, no kernel
            assert "Replaces: tpugs/ops/pallas/" in text
            assert "Bound on the H100" in text
    path = cuda_lib.library_path()
    assert path.parent.parent == cuda_lib.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.ARCH_FLAGS
    assert set(cuda_lib.SIGNATURES) >= {"tpugs_expand", "tpugs_align_copy",
                                        "tpugs_composite_fwd",
                                        "tpugs_composite_bwd",
                                        "tpugs_segreduce_sorted",
                                        "tpugs_segreduce_interval",
                                        "tpugs_guard_words"}
    assert cuda_lib.SIGNATURES["tpugs_guard_words"][0] is ctypes.c_int



def _train_scene(tmp_path):
    from tests.synthetic_scene import make_scene

    root = str(tmp_path / "scene")
    make_scene(root, num_images=9, width=32, height=24, num_points=20)
    return root, ["-d", root, "-o", str(tmp_path / "out"), "-i", "2",
                  "--capacity", "32", "--sh-degree", "0", "--log-every", "1",
                  "--save-every", "0", "--pair-capacity", "4096",
                  "--max-hits", "64"]


def test_train_cli_without_cuda_needs_device_cpu(monkeypatch, tmp_path):
    from tpugs_torch.apps import train as train_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, argv = _train_scene(tmp_path)
    argv += ["--no-densify"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_app.main(argv)
    assert not (tmp_path / "out").exists()
    assert train_app.main(argv + ["--device", "cpu", "--random-bg"]) == 0
    assert (tmp_path / "out" / "ckpt_0000002.npz").exists()


def test_train_mesh_larger_than_the_world_raises(tmp_path):
    """--mesh without a launcher: a mesh larger than the one process raises
    a ValueError that names torchrun, before anything is written."""
    from tpugs_torch.apps import train as train_app

    _, argv = _train_scene(tmp_path)
    with pytest.raises(ValueError, match="2\\*1 != 1 devices.*torchrun"):
        train_app.main(argv + ["--no-densify", "--mesh", "data=2",
                               "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_mesh_on_cuda_never_drops_to_gloo_or_the_cpu(monkeypatch, tmp_path):
    """A mesh on the card without one raises; in a gloo world a mesh on
    the card raises unless the caller names gloo."""
    import torch.distributed as dist

    from tpugs_torch.parallel import dist_train
    from tpugs_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_train.parse_mesh_spec("data=1,gauss=1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="'gloo'.*'nccl'"):
            make_mesh((1, 1), device="cuda:0")
        mesh = make_mesh((1, 1), device="cuda:0", backend="gloo")
        assert mesh.device == torch.device("cuda", 0)
        assert mesh.backend == "gloo"
        assert make_mesh((1, 1), device="cpu").backend == "gloo"
    finally:
        dist.destroy_process_group()


def test_train_trace_dir_writes_a_trace(tmp_path):
    """--trace-dir wraps the training in a torch.profiler trace, written
    into the directory, as tpugs' CLI wraps it in jax.profiler's."""
    import json

    from tpugs_torch.apps import train as train_app

    _, argv = _train_scene(tmp_path)
    trace_dir = tmp_path / "trace"
    assert train_app.main(argv + ["--no-densify", "--trace-dir",
                                  str(trace_dir), "--device", "cpu"]) == 0
    (trace,) = trace_dir.glob("trace_*.json")
    events = json.load(open(trace))["traceEvents"]
    assert len(events) > 100
    assert (tmp_path / "out" / "ckpt_0000002.npz").exists()


def _guard_on_call(monkeypatch, module, name: str, k: int) -> list:
    """Guard words as plain host memory, and module.name wrapped to set
    word k after each call, as its kernel does when it finds its inputs out
    of contract; returns the list of its calls."""
    words = (ctypes.c_int * len(cuda_lib.GUARDED))()
    monkeypatch.setattr(cuda_lib, "_guard_host", words)
    real, calls = getattr(module, name), []

    def call(*args, **kw):
        out = real(*args, **kw)
        words[k] = 1
        calls.append(name)
        return out

    monkeypatch.setattr(module, name, call)
    return calls


def test_render_cli_raises_on_a_violation_in_its_last_frame(monkeypatch,
                                                            tmp_path):
    """The align-copy of the render CLI's one and last frame finds its
    inputs out of contract: the offline renderer reads the guard words once
    the frame's kernels have run, so the CLI raises and writes no frame."""
    from tpugs_torch.io.ply import write_gaussian_ply_numpy
    from tpugs_torch.utils.synthetic import synthetic_params_numpy

    calls = _guard_on_call(monkeypatch, pack, "align_copy", 0)
    p = synthetic_params_numpy(20, seed=0)
    ply = tmp_path / "m.ply"
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    with pytest.raises(ValueError, match="tpugs_align_copy: .*tile 0 has"):
        render_app.main(["-m", str(ply), "-o", str(tmp_path / "f"),
                         "--frames", "1", "--width", "32", "--height", "32",
                         "--device", "cpu"])
    assert calls == ["align_copy"]
    assert not (tmp_path / "f" / "frame_0000.png").exists()


def test_trainer_raises_on_a_violation_in_its_last_step(monkeypatch,
                                                        tmp_path):
    """The interval segment sum of the Trainer's one and last step (the
    classic backward, SORTED_SEGRED_MIN raised) finds its inputs out of
    contract: the Trainer reads the guard words after the block's stats,
    so it raises before it logs or saves a checkpoint."""
    from tpugs_torch.ops import composite
    from tpugs_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(composite, "SORTED_SEGRED_MIN", 1 << 62)
    calls = _guard_on_call(monkeypatch, segreduce, "segment_reduce", 1)
    root, _ = _train_scene(tmp_path)
    out = tmp_path / "o"
    tr = Trainer(root, TrainConfig(iterations=1, capacity=32, sh_degree=0,
                                   log_every=1, save_every=0,
                                   densify_mode="none", pair_capacity=4096,
                                   max_hits_per_tile=64, output_dir=str(out)),
                 log_fn=lambda *_: None, device="cpu")
    with pytest.raises(ValueError, match="tpugs_segreduce_interval: .*gaussian 0"):
        tr.train(1)
    assert calls == ["segment_reduce"]
    assert not list(out.glob("model_*")) and not list(out.glob("ckpt_*"))
    assert (out / "history.jsonl").read_text() == ""


def test_forward_only_render_builds_no_graph():
    """render(need_grads=False) under no_grad, or with inputs that need no
    gradient (the render CLI's and the viewer's), builds no autograd graph.
    Its gradient, where an input needs one, is held against tpugs' in
    tests/test_torch_scatter.py."""
    from tpugs_torch.ops.render import render
    from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                             synthetic_params)

    p = {k: v.requires_grad_(True) for k, v in synthetic_params(30).items()}
    cfg = RasterConfig(img_h=24, img_w=32)
    intr = torch.from_numpy(synthetic_intrinsics_numpy(32, 24))
    alive = torch.ones(30, dtype=torch.bool)
    names = ("means", "quats", "log_scales", "opacity_logits", "sh")
    with torch.no_grad():
        out = render(*[p[k] for k in names], alive, torch.eye(4), intr, cfg, 3,
                     torch.zeros(3), need_grads=False)
    assert out.color.grad_fn is None
    out = render(*[p[k].detach() for k in names], alive, torch.eye(4), intr,
                 cfg, 3, torch.zeros(3), need_grads=False)
    assert out.color.grad_fn is None and out.means2d.grad_fn is None

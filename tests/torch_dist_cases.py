"""What the gloo ranks of the mesh tests run (tests/torch_dist.py): each
function takes (rank, world, **inputs as numpy) and returns numpy. Only
tpugs_torch is imported here, never JAX: the test process holds tpugs'
side."""
from __future__ import annotations

import numpy as np
import torch

from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.rasterize_tiled import RasterConfig
from tpugs_torch.optim.adam import AdamConfig, adam_init
from tpugs_torch.parallel import comm
from tpugs_torch.parallel.mesh import BOTH, make_mesh
from tpugs_torch.parallel.tile_shard import (assemble_image,
                                             exchange_and_render_local,
                                             local_raster_config)
from tpugs_torch.train.loss import combined_loss

NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _shard(mesh, x):
    n = x.shape[0] // mesh.gauss
    return _t(x[mesh.gauss_index * n:(mesh.gauss_index + 1) * n])


def _tile_forward(mesh, cfg, params, alive, viewmat, intr, sh_degree,
                  send_capacity=None, compositor="auto"):
    g = mesh.gauss
    local_cfg = local_raster_config(cfg, g, -(-cfg.pair_capacity // g))
    p = {k: _shard(mesh, v) for k, v in params.items()}
    a = _shard(mesh, alive)
    with torch.no_grad():
        proj = project_gaussians(p["means"], p["quats"], p["log_scales"],
                                 p["opacity_logits"], p["sh"], a, _t(viewmat),
                                 _t(intr), cfg.img_w, cfg.img_h, sh_degree)
        cap = send_capacity if send_capacity is not None else a.shape[0]
        color_t, _, _, diag = exchange_and_render_local(
            proj, cfg, local_cfg, mesh, cap, torch.zeros(3), compositor,
            need_grads=False)
        color = assemble_image(cfg, mesh, color_t)
        send_of = comm.all_reduce(diag["send_overflow"], mesh, BOTH, "max")
        pair_of = comm.all_reduce(diag["pair_overflow"], mesh, BOTH, "max")
    return color.numpy(), bool(send_of), bool(pair_of)


def _tile_grads(mesh, cfg, params, alive, images, viewmats, intr, sh_degree,
                compositor="auto"):
    """The normalised gradients and loss of the tile-sharded render, each
    data row on its own view."""
    g = mesh.gauss
    local_cfg = local_raster_config(cfg, g, -(-cfg.pair_capacity // g))
    p = {k: _shard(mesh, v).requires_grad_(True) for k, v in params.items()}
    a = _shard(mesh, alive)
    i = mesh.data_index
    proj = project_gaussians(p["means"], p["quats"], p["log_scales"],
                             p["opacity_logits"], p["sh"], a,
                             _t(viewmats[i]), _t(intr[i]), cfg.img_w,
                             cfg.img_h, sh_degree)
    color_t, _, _, _ = exchange_and_render_local(
        proj, cfg, local_cfg, mesh, a.shape[0], torch.zeros(3), compositor)
    color = assemble_image(cfg, mesh, color_t)
    loss = combined_loss(color, _t(images[i]), 0.2)
    grads = torch.autograd.grad(loss, [p[k] for k in NAMES])
    grads = comm.mean_over_data(dict(zip(NAMES, grads)), mesh)
    loss = comm.all_reduce(loss.detach(), mesh, "data", "mean")
    return _np(grads), float(loss)


def _one_step(make, mesh, cfg, params, alive, images, viewmats, intr,
              shard_params: bool, **make_kw):
    from tpugs_torch.parallel.gauss_shard import shard_gauss_state
    from tpugs_torch.parallel.sharded_train import replicate, shard_batch

    p = {k: _t(v) for k, v in params.items()}
    adam = adam_init(p)
    if shard_params:
        p, a, adam = shard_gauss_state(mesh, p, _t(alive), adam)
    else:
        p, a, adam = replicate(mesh, (p, _t(alive), adam))
    im, vm, it = shard_batch(mesh, images, viewmats, intr)
    step = make(mesh, cfg, AdamConfig(), sh_degree=1, **make_kw)
    new_p, _, loss = step(p, a, adam, im, vm, it, torch.zeros(()))
    return _np(new_p), float(loss)


def parallel_world(rank, world, params, alive, images, viewmats, intr, cfg,
                   densify, mcmc):
    """Every case of tests/test_torch_parallel.py that needs ranks, on the
    meshes 1x4, 2x2 and 4x1 of one 4-rank world."""
    from tpugs_torch.parallel.gauss_shard import make_gauss_sharded_train_step
    from tpugs_torch.parallel.sharded_train import make_dp_train_step
    from tpugs_torch.parallel.tile_shard import make_tile_sharded_train_step

    cfg = RasterConfig(**cfg)
    out = {}
    m14 = make_mesh((1, 4), device="cpu")
    m22 = make_mesh((2, 2), device="cpu")
    m41 = make_mesh((4, 1), device="cpu")
    for name, m in (("1x4", m14), ("2x2", m22)):
        out[f"forward_{name}"] = _tile_forward(m, cfg, params, alive,
                                               viewmats[0], intr[0], 1)
    out["forward_cap1"] = _tile_forward(m14, cfg, params, alive, viewmats[0],
                                        intr[0], 1, send_capacity=1)
    out["grads_2x2"] = _tile_grads(m22, cfg, params, alive, images[:2],
                                   viewmats[:2], intr[:2], 1)
    out["tile_step"] = _one_step(make_tile_sharded_train_step, m22, cfg,
                                 params, alive, images[:2], viewmats[:2],
                                 intr[:2], True)
    out["gauss_step"] = _one_step(make_gauss_sharded_train_step, m22, cfg,
                                  params, alive, images[:2], viewmats[:2],
                                  intr[:2], True)
    out["dp_step"] = _one_step(make_dp_train_step, m41, cfg, params, alive,
                               images, viewmats, intr, False)
    for name, m in (("g2", m22), ("g4", m14)):
        out[f"densify_{name}"] = _densify(m, **densify[name])
    for name, m in (("g2", m22), ("g4", m14), ("g2_jitter", m22)):
        out[f"mcmc_{name}"] = _mcmc(m, **mcmc[name])
    out["mesh"] = (m22.data_index, m22.gauss_index, m14.gauss_index,
                   m41.data_index)
    return out


def scan_world(rank, world, params, alive, images, viewmats, intr, cfg):
    """The tile-sharded scan route (compositor="scan") on a 2x2 mesh: the
    forward, the normalised gradients and one tile-sharded train step."""
    from tpugs_torch.parallel.tile_shard import make_tile_sharded_train_step

    cfg = RasterConfig(**cfg)
    m22 = make_mesh((2, 2), device="cpu")
    return {
        "forward": _tile_forward(m22, cfg, params, alive, viewmats[0],
                                 intr[0], 1, compositor="scan"),
        "grads": _tile_grads(m22, cfg, params, alive, images[:2],
                             viewmats[:2], intr[:2], 1, compositor="scan"),
        "tile_step": _one_step(make_tile_sharded_train_step, m22, cfg,
                               params, alive, images[:2], viewmats[:2],
                               intr[:2], True, compositor="scan"),
    }


def _densify(mesh, flat, noise, pruning, extent, cfg):
    """make_dist_densify_step on this rank's shard with tpugs' noise."""
    from tpugs_torch.core.gaussians import (train_state_from_numpy,
                                            train_state_to_numpy)
    from tpugs_torch.optim.densify_adc import ADCConfig
    from tpugs_torch.parallel.dist_train import (make_dist_densify_step,
                                                 shard_numpy_state)
    from tpugs_torch.train.trainer import TrainConfig

    state = train_state_from_numpy(shard_numpy_state(flat, mesh), "cpu")
    step = make_dist_densify_step(TrainConfig(adc=ADCConfig(**cfg)), mesh,
                                  extent)
    n1, n2 = noise[mesh.gauss_index]
    new, stats = step(state, size_pruning_active=pruning,
                      noise=(_t(n1), _t(n2)))
    return train_state_to_numpy(new), {k: int(v) for k, v in stats.items()}


def _mcmc(mesh, params, alive, draws, extent, cfg):
    """dist_relocate and dist_grow on this rank's shard with tpugs' draws."""
    from tpugs_torch.optim.densify_mcmc import MCMCConfig
    from tpugs_torch.parallel.dist_mcmc import dist_grow, dist_relocate

    cfg = MCMCConfig(**cfg)
    p = {k: _shard(mesh, v) for k, v in params.items()}
    a = _shard(mesh, alive)
    d = {k: {n: _t(v) for n, v in draws[k][mesh.gauss_index].items()}
         for k in ("relocate", "grow")}
    rp, rchg, rstats = dist_relocate(cfg, p, a, extent, mesh,
                                     draws=d["relocate"])
    gp, galive, gchg, n_new = dist_grow(cfg, p, a, extent, mesh,
                                        draws=d["grow"])
    return (_np(rp), rchg.numpy(), {k: int(v) for k, v in rstats.items()},
            _np(gp), galive.numpy(), gchg.numpy(), int(n_new))


def trainer_world(rank, world, scene, out, runs):
    """Trainers on this rank of the world's mesh, one per run spec (name,
    TrainConfig kwargs, iterations, resume_from or None). Returns, per
    run, the rank's log lines, history losses, send capacity, its data
    row's gathered state after init and after training, a few fields of
    gaussian_state() after training, and evaluate()'s PSNR when asked for
    ("eval" in the spec's kwargs)."""
    import os

    from tpugs_torch.optim.densify_adc import ADCConfig
    from tpugs_torch.optim.densify_mcmc import MCMCConfig
    from tpugs_torch.parallel.dist_train import gathered_numpy_state
    from tpugs_torch.train.trainer import TrainConfig, Trainer

    results = {}
    for name, kw, iters, resume in runs:
        kw = dict(kw)
        do_eval = kw.pop("eval", False)
        if "adc" in kw:
            kw["adc"] = ADCConfig(**kw["adc"])
        if "mcmc" in kw:
            kw["mcmc"] = MCMCConfig(**kw["mcmc"])
        logs = []
        tr = Trainer(scene, TrainConfig(output_dir=os.path.join(out, name),
                                        **kw),
                     log_fn=logs.append, device="cpu",
                     resume_from=resume and os.path.join(out, resume))
        init = gathered_numpy_state(tr.mesh, tr.state)
        hist = tr.train(iters)
        res = dict(logs=logs, losses=[h["loss"] for h in hist],
                   steps=[h["step"] for h in hist],
                   send_capacity=tr.cfg.dist_send_capacity,
                   max_hits=tr.raster.max_hits_per_tile,
                   start_step=tr.start_step, init=init,
                   final=gathered_numpy_state(tr.mesh, tr.state))
        model = tr.gaussian_state()
        res["model"] = {k: getattr(model, k).numpy() for k in
                        ("means", "sh", "alive")}
        if do_eval:
            res["psnr"] = tr.evaluate().mean_psnr
        results[name] = res
    return results


def cli_world(rank, world, scene, out):
    """The train CLI with --mesh data=1,gauss=2 and the quality CLI with
    --mesh data=2,gauss=1 on this world's two ranks."""
    import os

    from tpugs_torch.apps.quality import main as quality_main
    from tpugs_torch.apps.train import main as train_main

    rc = train_main(["-d", scene, "-o", os.path.join(out, "train"), "-i",
                     "11", "--capacity", "128", "--sh-degree", "1",
                     "--log-every", "10", "--save-every", "0",
                     "--pair-capacity", "16384", "--max-hits", "128",
                     "--tile", "16", "--densify-from", "10",
                     "--densify-every", "10", "--mesh", "data=1,gauss=2",
                     "--device", "cpu"])
    qrc = quality_main(["-i", "6", "-o", os.path.join(out, "quality"),
                        "--gaussians", "300", "--views", "9", "--width",
                        "64", "--height", "48", "--capacity", "1024",
                        "--log-every", "5", "--mesh", "data=2,gauss=1",
                        "--device", "cpu"])
    return rc, qrc


# make_dist_multi_step (tests/test_torch_dist_multistep.py).

_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist")


class _EagerRunner:
    """graph.BlockRunner with every replay replaced by an eager call of the
    captured body (tests/test_torch_multistep.py's stand-in, here without
    JAX): the card path's bookkeeping (static buffers, staged rows, the
    step counter, generator re-seeding) on the CPU."""

    captures_total = replays_total = 0

    def __init__(self, device, width, generators=()):
        self.device, self.width = device, width
        self.generators = tuple(generators)
        self.graphs, self.rows, self.losses = {}, None, None
        self.counter = torch.zeros((1,), dtype=torch.int64)
        self.captures = self.replays = 0
        self.capture_seconds = []

    def release(self, keep=lambda key: False):
        for key in [k for k in self.graphs if not keep(k)]:
            del self.graphs[key]

    def stage(self, rows):
        k = rows.shape[0]
        if self.rows is None or self.rows.shape[0] < k:
            self.rows = torch.zeros((max(k, 32), self.width))
            self.losses = torch.zeros((max(k, 32),))
            self.release()
        self.rows[:k] = torch.from_numpy(np.asarray(rows, np.float32))
        self.counter.zero_()

    def row(self):
        return self.rows.index_select(0, self.counter)[0]

    def put_loss(self, loss):
        self.losses.index_copy_(0, self.counter, loss.reshape(1))

    def advance(self):
        self.counter.add_(1)

    def run(self, key, k, body, before_step=None):
        if key not in self.graphs:
            self.graphs[key] = body
            self.captures += 1
        for j in range(k):
            if before_step is not None:
                before_step(j)
            self.graphs[key]()
        self.replays += k
        return 0


class _NoHostReads:
    """Tensor.item, __bool__, __int__, __float__, __index__ and tolist raise
    while it is entered, except inside the kernels' plain versions, which
    read by design and never run on the card (their wrappers launch the
    kernels there)."""

    PLAIN = (("composite_t", "composite_forward_plain"),
             ("composite_t", "composite_backward_plain"),
             ("segreduce", "segment_sum_sorted_plain"),
             ("segreduce", "segment_reduce_plain"),
             ("pack", "align_copy_plain"), ("expand", "expand_pairs_plain"))

    def __init__(self):
        self.allowed = 0

    def __enter__(self):
        import importlib

        self.saved = {n: getattr(torch.Tensor, n) for n in _READS}
        self.plain = []
        for n in _READS:
            setattr(torch.Tensor, n, self._guard(n))
        for mod, name in self.PLAIN:
            m = importlib.import_module(f"tpugs_torch.ops.{mod}")
            fn = getattr(m, name)
            self.plain.append((m, name, fn))
            setattr(m, name, self._allow(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)
        for m, name, fn in self.plain:
            setattr(m, name, fn)

    def _guard(self, name):
        real = self.saved[name]

        def read(*a, **k):
            if self.allowed:
                return real(*a, **k)
            raise AssertionError(f"a host read: Tensor.{name}")
        return read

    def _allow(self, fn):
        def plain(*a, **k):
            self.allowed += 1
            try:
                return fn(*a, **k)
            finally:
                self.allowed -= 1
        return plain


def _state_diffs(a, b) -> list:
    """The tensors of two TrainStates that are not bit-equal, by name."""
    pairs = [(f"params/{k}", a.params[k], b.params[k]) for k in a.params]
    pairs += [(f"adam_m/{k}", a.adam.m[k], b.adam.m[k]) for k in a.params]
    pairs += [(f"adam_v/{k}", a.adam.v[k], b.adam.v[k]) for k in a.params]
    pairs += [("adam_count", a.adam.count, b.adam.count),
              ("alive", a.alive, b.alive)]
    pairs += [(f"adc/{f}", getattr(a.adc, f), getattr(b.adc, f))
              for f in ("grad_accum", "grad_count", "max_radii")]
    out = [name for name, x, y in pairs if not torch.equal(x, y)]
    if not (np.asarray(a.key) == np.asarray(b.key)).all():
        out.append("key")
    return out


def _stats_np(stats) -> dict:
    import dataclasses

    return {f.name: _np(getattr(stats, f.name))
            for f in dataclasses.fields(stats)
            if getattr(stats, f.name) is not None}


def dist_multistep_jax_world(rank, world, cases, raster, extent):
    """make_dist_multi_step on this rank of a data=2,gauss=2 mesh, per case:
    the global state (tpugs', as numpy) sharded onto the rank, its data
    row's block of the bank, its column of the [K, D] view draw. Returns
    per case the losses, the last stats and the data row's gathered
    state."""
    from tpugs_torch.core.gaussians import train_state_from_numpy
    from tpugs_torch.parallel.dist_train import (gathered_numpy_state,
                                                 make_dist_multi_step,
                                                 shard_numpy_state)
    from tpugs_torch.train.trainer import TrainConfig

    raster = RasterConfig(**raster)
    mesh = make_mesh((2, 2), device="cpu")
    i = mesh.data_index
    out = {}
    for name, c in cases.items():
        state = train_state_from_numpy(shard_numpy_state(c["flat"], mesh),
                                       "cpu")
        vpr = c["images"].shape[0] // mesh.data
        row = slice(i * vpr, (i + 1) * vpr)
        multi = make_dist_multi_step(TrainConfig(**c["cfg"]), raster, mesh,
                                     extent)
        state, losses, stats = multi(
            state, _t(c["images"][row]), _t(c["viewmats"][row]),
            _t(c["intrinsics"][row]), c["view_idx"][:, i], c["step0"],
            c["sh_degree"])
        out[name] = dict(losses=_np(losses), stats=_stats_np(stats),
                         state=gathered_numpy_state(mesh, state))
    return out


def dist_multistep_world(rank, world, scene, out):
    """On a data=1,gauss=2 mesh from a Trainer's state two steps in: (a) per
    densify mode, the multi-step against K make_dist_train_step calls; (b)
    per mode, the graphed path (graph.BlockRunner made eager) over two
    blocks with an event between, against the eager multi-step, under no
    host reads; (c) Trainers whose blocks run the graphed path against
    eager ones. Returns what differs, the counts and the losses."""
    import dataclasses
    import os

    from tpugs_torch.optim.densify_adc import ADCConfig
    from tpugs_torch.parallel import dist_train as DT
    from tpugs_torch.train import graph
    from tpugs_torch.train import trainer as TT

    base = dict(sh_degree=1, capacity=128, save_every=0, log_every=1,
                pair_capacity=1 << 14, max_hits_per_tile=128, tile_h=16,
                tile_w=16, auto_pair_capacity=False, mesh="data=1,gauss=2")
    tr = TT.Trainer(scene, TT.TrainConfig(output_dir=os.path.join(out, "t"),
                                          **base),
                    log_fn=lambda *_: None, device="cpu")
    tr.train(2)
    mesh, raster, extent = tr.mesh, tr.raster, tr.scene_extent
    bank = (tr._image_bank(), tr._viewmats, tr._intrinsics)
    views = [np.asarray([1, 0, 2]), np.asarray([2, 2, 0])]
    res = {}
    for mode in ("adc", "mcmc", "none"):
        cfg = dataclasses.replace(tr.cfg, densify_mode=mode)
        # (a) K steps of the multi-step are K eager steps.
        multi = DT.make_dist_multi_step(cfg, raster, mesh, extent)
        step = DT.make_dist_train_step(cfg, raster, mesh, extent)
        s_m, l_m, st_m = multi(tr.state, *bank, views[0], 2, 1)
        ref, losses = tr.state, []
        for j, v in enumerate(views[0]):
            ref, st = step(ref, bank[0][v], bank[1][v], bank[2][v],
                           torch.tensor(float(2 + j)), 1)
            losses.append(st.loss)
        res[f"steps_{mode}"] = dict(
            diffs=_state_diffs(s_m, ref),
            losses_equal=bool(torch.equal(l_m, torch.stack(losses))),
            stats_equal=all(torch.equal(getattr(st_m, f), getattr(st, f))
                            for f in _stats_np(st)),
            graphed=len(multi.graphed))

        # (b) The graphed path's bookkeeping.
        real = graph.BlockRunner
        graph.BlockRunner = _EagerRunner
        try:
            core = DT._make_dist_step_core(cfg, raster, mesh,
                                           send_capacity=DT._send_capacity(
                                               cfg, None))
            g_multi = TT._multi_step_of(cfg, raster, core, mesh.gauss_index,
                                        graphed_on=lambda dev: True)
            event = (DT.make_dist_reset_opacity_step(mesh) if mode == "adc"
                     else (lambda s: DT.make_dist_relocate_step(
                         cfg, mesh, extent)(s)[0]))
            s_g = s_e = tr.state
            lg, le = [], []
            for b, vi in enumerate(views):
                with _NoHostReads():
                    s_g, l_g, st_g = g_multi(s_g, *bank, vi, 2 + 3 * b, 1)
                s_e, l_e, st_e = multi(s_e, *bank, vi, 2 + 3 * b, 1)
                lg.append(l_g.clone())
                le.append(l_e)
                if b == 0:
                    ptr = s_g.params["means"].data_ptr()
                    s_g, s_e = event(s_g), event(s_e)
        finally:
            graph.BlockRunner = real
        g = g_multi.graphed[torch.device("cpu")]
        seed = None
        if mode == "mcmc":  # the last step's: its key and the shard's index
            seed = (g.noise.initial_seed(), TT._generator_seed(
                s_e.key - np.asarray([0, 1], np.uint32), TT.NOISE_STREAM,
                mesh.gauss_index))
        res[f"graphed_{mode}"] = dict(
            diffs=_state_diffs(s_g, s_e),
            losses_equal=all(torch.equal(a, b) for a, b in zip(lg, le)),
            stats_equal=all(torch.equal(getattr(st_g, f), getattr(st_e, f))
                            for f in _stats_np(st_e)),
            static=s_g.params["means"].data_ptr() == ptr,
            captures=g.runner.captures, replays=g.runner.replays, seed=seed)

    # (c) Trainers through the graphed block against eager ones.
    runs = {"adc": dict(base, adc=ADCConfig(densify_from=4, densify_every=4,
                                            densify_until=20,
                                            opacity_reset_every=8)),
            "send": dict(base, densify_mode="none", dist_send_capacity=1)}
    for name, kw in runs.items():
        finals = {}
        for way in ("graphed", "eager"):
            saved = DT._graphed_on
            if way == "graphed":
                DT._graphed_on = lambda dev, m: True
                graph.BlockRunner = _EagerRunner
            logs = []
            try:
                t = TT.Trainer(scene, TT.TrainConfig(
                    output_dir=os.path.join(out, f"{name}_{way}"), **kw),
                    log_fn=logs.append, device="cpu")
                hist = t.train(12)
            finally:
                DT._graphed_on = saved
                graph.BlockRunner = real
            runner = [g.runner for g in t._multi_step.graphed.values()]
            finals[way] = dict(
                losses=[h["loss"] for h in hist],
                state=DT.gathered_numpy_state(mesh, t.state),
                send_capacity=t.cfg.dist_send_capacity,
                events=[ln for ln in logs if "densify:" in ln
                        or "opacity reset" in ln or "OVERFLOW" in ln],
                replays=sum(r.replays for r in runner))
        res[f"trainer_{name}"] = finals
    return res

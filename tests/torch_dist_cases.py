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

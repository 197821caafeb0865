"""The distributed Trainer's steps on a ("data", "gauss") mesh, as
tpugs/parallel/dist_train.py:

- gaussian parameters, Adam moments, ADC accumulators and the alive mask:
  sharded over "gauss" (N/G rows per rank);
- the tile grid: sharded over "gauss" too (tile_shard.py's exchange);
- the views: each data row holds its own block (V/D views); a step takes
  one view per data row, so D views per step, and averages the gradients
  over the data group;
- random draws: per shard, from generators that fold in the gauss index,
  so every data row draws the same bits and the replicas of a shard stay
  bit-identical.

A block of K steps (make_dist_multi_step, tpugs' one compiled scan)
runs on the card as replays of the mesh step captured as a CUDA graph
where the capture can hold every collective: on a mesh whose axes all
have size 1 (no collective) or on NCCL. gloo takes card tensors through
host memory and cannot be captured, so on a gloo mesh, and on the CPU,
the block runs its K steps eagerly.

Gradient normalisation (parallel/comm.py): a rank's raw gradient is
d(its data row's loss)/d(its shard), and the mean over the data group is
tpugs' normalised gradient (tpugs divides its G x D-fold raw gradient by
G after its mean over "data"). The screen-space probe gradient that ADC
accumulates is the row's own per-view gradient (tpugs': d_probe / G); its
norms are summed over the data group, so the accumulators count all D
views of a step, and every data row holds the same ADC state.

ADC's densify event runs shard-local: each shard clones, splits and
prunes within its own slots, so the initial slots are interleaved across
shards (the Trainer). MCMC's relocation and growth sample globally
(dist_mcmc.py). Event statistics are summed over the gauss group. The
opacity reset touches each slot alone, so make_dist_reset_opacity_step
is the Trainer's reset_opacity_step (tpugs wraps the same function in a
shard_map).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpugs_torch.device import device_constant
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.rasterize_tiled import RasterConfig
from tpugs_torch.optim.adam import adam_step, zero_slots
from tpugs_torch.optim.densify_adc import ADCState, adc_densify
from tpugs_torch.optim.densify_mcmc import inject_noise
from tpugs_torch.parallel import comm
from tpugs_torch.parallel.dist_mcmc import dist_grow, dist_relocate
from tpugs_torch.parallel.mesh import BOTH, Mesh, make_mesh
from tpugs_torch.parallel.tile_shard import (assemble_image,
                                             default_local_pair_capacity,
                                             destination_range,
                                             exchange_and_render_local,
                                             local_raster_config)
from tpugs_torch.train.loss import combined_loss

# Checkpoint fields held whole on every rank; the rest are sharded by rows.
REPLICATED = ("adam_count", "key")


def mesh_axis_sizes(spec: str, n_devices: int) -> tuple[int, int]:
    """(data, gauss) from a spec like "data=2,gauss=4" over n_devices
    ranks; one axis may be -1, inferred from the other."""
    sizes = {"data": 1, "gauss": 1}
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in sizes:
            raise ValueError(f"unknown mesh axis {name!r} (use data/gauss)")
        sizes[name] = int(val)
    n = n_devices
    inferred = [k for k, v in sizes.items() if v == -1]
    if len(inferred) > 1:
        raise ValueError(
            f"mesh spec {spec!r}: at most one axis may be -1 (inferred)")
    if inferred:
        other = [v for k, v in sizes.items() if k != inferred[0]][0]
        if other <= 0 or n % other:
            raise ValueError(
                f"mesh spec {spec!r}: cannot infer {inferred[0]}=-1 — "
                f"{n} devices not divisible by {other}")
        sizes[inferred[0]] = n // other
    if sizes["data"] * sizes["gauss"] != n:
        raise ValueError(
            f"mesh spec {spec!r}: axis product "
            f"{sizes['data']}*{sizes['gauss']} != {n} devices")
    return sizes["data"], sizes["gauss"]


def parse_mesh_spec(spec: str, n_devices: int | None = None, device=None,
                    backend: str | None = None) -> Mesh:
    """A mesh from a CLI spec like "data=2,gauss=4" over the world's ranks
    (n_devices: the world size, 1 without a process group). A mesh larger
    than the world raises and names the launcher."""
    import torch.distributed as dist

    world = n_devices is None
    if world:
        n_devices = (dist.get_world_size() if dist.is_available()
                     and dist.is_initialized() else 1)
    try:
        sizes = mesh_axis_sizes(spec, n_devices)
    except ValueError as e:
        if not world:
            raise
        raise ValueError(
            f"{e} (the world's ranks); launch one process per rank: "
            f"torchrun --nproc-per-node <data*gauss> (or the TPUGS_* "
            f"variables on each host)") from None
    return make_mesh(sizes, device, backend)


def _is_sharded(name: str) -> bool:
    return name not in REPLICATED


def shard_numpy_state(flat: dict, mesh: Mesh) -> dict:
    """A global state as numpy arrays, named as in a checkpoint
    (params/<name>, alive, adam_m/<name>, ..., key) -> this rank's shard
    (rows [i N/G, (i+1) N/G) of every sharded field). With
    core.gaussians.train_state_from_numpy this carries tpugs' mesh state,
    or a checkpoint, onto the ranks."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if _is_sharded(k):
            n = v.shape[0] // mesh.gauss
            v = v[mesh.gauss_index * n:(mesh.gauss_index + 1) * n]
        out[k] = v
    return out


def _gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x's rows gathered over the gauss group, on x's device (a bool as
    uint8)."""
    if x.dtype == torch.bool:
        return comm.all_gather(x.to(torch.uint8), mesh, "gauss").bool()
    return comm.all_gather(x, mesh, "gauss")


def gathered_params(mesh: Mesh, params: dict, alive):
    """The whole model on this rank's device: (params, alive) gathered over
    the gauss group (a collective: all ranks call it together). What
    evaluation and a GaussianState need, and no more: at SH 3, 59 floats
    and a byte per slot on each card, no host copy."""
    return ({k: _gather_rows(v, mesh) for k, v in params.items()},
            _gather_rows(alive, mesh))


def gathered_train_state(mesh: Mesh, state):
    """The whole TrainState on this rank's device, every sharded field
    gathered over the gauss group (a collective). At SH 3 about 180
    floats a slot (params, both Adam moments, the ADC accumulators): 12
    GB on each card at 2^24 slots."""
    from tpugs_torch.optim.adam import AdamState
    from tpugs_torch.train.trainer import TrainState

    g = lambda x: _gather_rows(x, mesh)
    params, alive = gathered_params(mesh, state.params, state.alive)
    adam, adc = state.adam, state.adc
    return TrainState(
        params=params, alive=alive,
        adam=AdamState(m={k: g(v) for k, v in adam.m.items()},
                       v={k: g(v) for k, v in adam.v.items()},
                       count=adam.count),
        adc=ADCState(grad_accum=g(adc.grad_accum),
                     grad_count=g(adc.grad_count),
                     max_radii=g(adc.max_radii)),
        key=state.key)


def gathered_numpy_state(mesh: Mesh, state) -> dict:
    """The whole state as numpy in the checkpoint's names, on every rank
    of the data row (a collective)."""
    from tpugs_torch.core.gaussians import train_state_to_numpy

    return train_state_to_numpy(gathered_train_state(mesh, state))


def shard_train_state(mesh: Mesh, state):
    """A whole TrainState (on any device) -> this rank's shard on its
    device."""
    from tpugs_torch.core.gaussians import (train_state_from_numpy,
                                            train_state_to_numpy)

    return train_state_from_numpy(
        shard_numpy_state(train_state_to_numpy(state), mesh), mesh.device)


def measure_max_send_count(mesh: Mesh, raster: RasterConfig, params: dict,
                           alive, viewmats, intrinsics) -> int:
    """The worst count any rank sends to one destination over the sample
    views (the exchange's auto-tuned capacity starts from it): one
    projection of the local shard per view, no exchange."""
    g = mesh.gauss
    worst = []
    with torch.no_grad():
        dst = torch.arange(g, device=mesh.device)[:, None]
        for vm, intr in zip(viewmats, intrinsics):
            proj = project_gaussians(
                params["means"], params["quats"], params["log_scales"],
                params["opacity_logits"], params["sh"], alive,
                torch.as_tensor(vm, dtype=torch.float32, device=mesh.device),
                torch.as_tensor(intr, dtype=torch.float32,
                                device=mesh.device),
                raster.img_w, raster.img_h, 0)
            d0, d1 = destination_range(proj, raster, g)
            counts = ((d0[None, :] <= dst) & (dst <= d1[None, :])).sum(1)
            worst.append(torch.max(counts))
        worst = comm.all_reduce(torch.stack(worst).max(), mesh, BOTH, "max")
    return int(worst)


def auto_send_capacity(worst: int, n_loc: int) -> int:
    """The exchange's slots per (source, destination) from the worst send
    count measured: 1.3x it in multiples of 128, at least 128, at most the
    safe N/G."""
    return max(min(-(-int(worst * 1.3) // 128) * 128, n_loc), 128)


def _sharded_regularization(mcmc_cfg, params: dict, alive, mesh: Mesh):
    """MCMC's regularization with global means: the shards' sums added over
    the gauss group, so every rank of a data row computes the same value."""
    zero = torch.zeros((), dtype=torch.float32, device=alive.device)
    opac = torch.where(alive, torch.sigmoid(params["opacity_logits"]), zero)
    scales = torch.where(alive[:, None], torch.exp(params["log_scales"]), zero)
    sums = comm.all_reduce_sum(torch.stack([
        torch.sum(alive.to(torch.float32)), torch.sum(opac),
        torch.sum(scales)]), mesh, "gauss")
    n = torch.clamp(sums[0], min=1.0)
    return (mcmc_cfg.lambda_opacity * sums[1] / n
            + mcmc_cfg.lambda_scale * sums[2] / (3.0 * n))


def _step_stats(diag: dict, mesh: Mesh, raster: RasterConfig, loss, l1):
    """StepStats over the mesh, from one gather of every rank's counts:
    pairs summed over the gauss shards (the worst data row), the busiest
    tile and the worst rank's pairs and sends, any overflow."""
    from tpugs_torch.train.trainer import StepStats

    keys = ("num_pairs", "max_tile_hits", "pair_overflow", "send_overflow",
            "max_send_count")
    vec = torch.stack([diag[k].to(torch.int64) for k in keys])
    m = comm.all_gather(vec[None], mesh, BOTH).reshape(
        mesh.data, mesh.gauss, len(keys))
    max_hits = m[..., 1].max()
    return StepStats(
        loss=loss, l1=l1, num_pairs=m[..., 0].sum(1).max(),
        pair_overflow=m[..., 2].max() > 0, max_tile_hits=max_hits,
        hit_overflow=max_hits > raster.max_hits_per_tile,
        max_local_pairs=m[..., 0].max(), send_overflow=m[..., 3].max() > 0,
        max_send_count=m[..., 4].max())


def _make_dist_step_core(cfg, raster: RasterConfig, mesh: Mesh,
                         compositor: str = "auto",
                         send_capacity: int | None = None):
    """The mesh step's computation on explicit inputs, trainer's
    _make_step_core contract on a shard: (state, image, viewmat,
    intrinsics, step, sh_degree, background [3], noise generator) ->
    (params, AdamState, ADCState, StepStats with the mesh fields), all new
    tensors. send_capacity: the exchange's slots per (source,
    destination), None for the safe N/G."""
    g, d = mesh.gauss, mesh.data
    local_cfg = local_raster_config(
        raster, g, default_local_pair_capacity(raster.pair_capacity, g))
    adc_mode = cfg.densify_mode == "adc"
    mcmc_mode = cfg.densify_mode == "mcmc"
    half_wh = (raster.img_w * 0.5, raster.img_h * 0.5)

    def core(state, image, viewmat, intrinsics, step, sh_degree: int,
             background, noise_gen):
        dev = image.device
        n_loc = state.alive.shape[0]
        cap = send_capacity if send_capacity is not None else n_loc
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        proj = project_gaussians(
            params["means"], params["quats"], params["log_scales"],
            params["opacity_logits"], params["sh"], state.alive, viewmat,
            intrinsics, raster.img_w, raster.img_h, sh_degree)
        probe = None
        if adc_mode:
            probe = torch.zeros((n_loc, 2), device=dev, requires_grad=True)
            proj = dataclasses.replace(proj, means2d=proj.means2d + probe)
        color_t, _, _, diag = exchange_and_render_local(
            proj, raster, local_cfg, mesh, cap, background, compositor)
        color = assemble_image(raster, mesh, color_t)
        loss = combined_loss(color, image, cfg.lambda_ssim)
        if mcmc_mode:
            loss = loss + _sharded_regularization(cfg.mcmc, params,
                                                  state.alive, mesh)
        names = list(params)
        grads = torch.autograd.grad(
            loss, [params[k] for k in names] + ([probe] if adc_mode else []))
        with torch.no_grad():
            l1 = torch.mean(torch.abs(color - image))
            # One sum over the data group: the gradients, loss and L1 (then
            # divided by D: the mean over the step's views) and ADC's norms
            # and counts (summed: every view of the step accumulates).
            parts = [grads[i].reshape(-1) for i in range(len(names))]
            parts += [loss.detach().reshape(1), l1.reshape(1)]
            if adc_mode:
                visible = proj.radii > 0
                gs = grads[-1] * device_constant(half_wh, dev)
                norms = torch.sqrt(torch.sum(gs * gs, dim=-1))
                parts += [torch.where(visible, norms, torch.zeros_like(norms)),
                          visible.to(torch.float32)]
            flat = comm.all_reduce(torch.cat(parts), mesh, "data", "sum")
            sizes = [p.numel() for p in parts]
            pieces = list(torch.split(flat, sizes))
            mean = {k: (pieces[i] / d).reshape(params[k].shape)
                    for i, k in enumerate(names)}
            loss_m = pieces[len(names)][0] / d
            l1_m = pieces[len(names) + 1][0] / d
            new_params, new_adam = adam_step(cfg.adam, state.adam,
                                             state.params, mean, step)
            adc = state.adc
            if adc_mode:
                radii_max = comm.all_reduce(proj.radii.to(torch.float32),
                                            mesh, "data", "max")
                adc = ADCState(
                    grad_accum=adc.grad_accum + pieces[-2],
                    grad_count=adc.grad_count + pieces[-1],
                    max_radii=torch.maximum(adc.max_radii, radii_max))
            if mcmc_mode:
                new_params = inject_noise(cfg.mcmc, new_params, state.alive,
                                          step, noise_gen)
            stats = _step_stats(diag, mesh, raster, loss_m, l1_m)
        return new_params, new_adam, adc, stats

    return core


def _send_capacity(cfg, send_capacity: int | None) -> int | None:
    """The exchange's slots per (source, destination): the one asked for,
    else cfg.dist_send_capacity when it is set, else None (the safe N/G)."""
    if send_capacity is None and cfg.dist_send_capacity > 0:
        return cfg.dist_send_capacity
    return send_capacity


def make_dist_train_step(cfg, raster: RasterConfig, mesh: Mesh,
                         scene_extent: float, compositor: str = "auto"):
    """One distributed training step on this rank, trainer.make_train_step's
    contract on a shard: step(state, image, viewmat, intrinsics, step,
    sh_degree) -> (state, StepStats), the view being this rank's data
    row's. The exchange's slots per (source, destination):
    cfg.dist_send_capacity when it is set, else the safe N/G. compositor:
    tile_shard.exchange_and_render_local's ("scan": the scan oracle)."""
    from tpugs_torch.train.trainer import _step_of

    return _step_of(cfg, _make_dist_step_core(
        cfg, raster, mesh, compositor, _send_capacity(cfg, None)),
        mesh.gauss_index)


def graph_capturable(mesh: Mesh) -> bool:
    """Whether the mesh step can be captured as a CUDA graph: every axis
    of size 1 (each collective is the identity) or NCCL (whose collectives
    a capture records); gloo takes card tensors through host memory and
    cannot be captured. It depends on the mesh alone, so every rank
    decides alike."""
    return mesh.size == 1 or mesh.backend == "nccl"


def _graphed_on(dev: torch.device, mesh: Mesh) -> bool:
    """Whether a block on `dev` runs as graph replays."""
    return dev.type == "cuda" and graph_capturable(mesh)


def make_dist_multi_step(cfg, raster: RasterConfig, mesh: Mesh,
                         scene_extent: float, compositor: str = "auto",
                         send_capacity: int | None = None):
    """K distributed steps per call, tpugs' make_dist_multi_step (K steps in
    one jitted scan over the mesh) on this rank:

        multi_step(state, images [V_row, H, W, 3], viewmats [V_row, 4, 4],
                   intrinsics [V_row, 4], view_idx [K], step0, sh_degree)
          -> (state, losses [K], last StepStats)

    images, viewmats, intrinsics: this rank's data row's view bank;
    view_idx: this rank's column of the block's [K, D] draw of local view
    indices, host ints; step0: the schedule step of the first step. Step j
    is make_dist_train_step's step at schedule step step0 + j with the key
    advanced j times. send_capacity: the exchange's slots per (source,
    destination); by default cfg.dist_send_capacity when it is set, else
    the safe N/G. compositor: make_dist_train_step's.

    How a block runs is decided by the bank's device and the mesh alone
    (graph_capturable), so every rank runs it alike: on the card, where
    every axis has size 1 or the backend is NCCL, as replays of the mesh
    step captured as a CUDA graph, trainer.make_train_multi_step's card
    path (one staged copy of the block's view indices, schedule steps and
    backgrounds before it, no host read and no copy from the host inside
    it, its losses and stats read after it; MCMC's noise from a generator
    registered with the graph, re-seeded before each step from the key
    and the gauss shard's index; a failed capture raises); on the CPU, or
    on a gloo mesh on the card, K eager make_dist_train_step steps. The
    graphed block's state is its static buffers, as on one device."""
    from tpugs_torch.train.trainer import _multi_step_of

    core = _make_dist_step_core(cfg, raster, mesh, compositor,
                                _send_capacity(cfg, send_capacity))
    return _multi_step_of(
        cfg, raster, core, mesh.gauss_index,
        graphed_on=lambda dev: _graphed_on(dev, mesh))


def make_dist_reset_opacity_step(mesh: Mesh):
    """tpugs' make_dist_reset_opacity_step: the opacity reset on this
    shard. It touches each slot alone and needs no collective, so the
    single-device reset_opacity_step serves a shard as it is (tpugs wraps
    the same function in a shard_map)."""
    from tpugs_torch.train.trainer import reset_opacity_step

    return reset_opacity_step


def _sum_stats(stats: dict, mesh: Mesh) -> dict:
    """An event's per-shard counts summed over the gauss group."""
    vals = comm.all_reduce(torch.stack([torch.as_tensor(v).to(torch.int64)
                                        for v in stats.values()]),
                           mesh, "gauss")
    return dict(zip(stats, vals))


def make_dist_densify_step(cfg, mesh: Mesh, scene_extent: float):
    """An ADC event on this shard: shard-local clone, split and prune (each
    shard keeps its own free slots), the moments of the slots it rewrote
    zeroed; stats summed over the gauss group. noise: (noise1, noise2) in
    place of the shard's draws."""
    from tpugs_torch.train.trainer import (DENSIFY_STREAM, TrainState,
                                           event_generator)

    def densify(state, size_pruning_active: bool, noise=None):
        gen = event_generator(state.key, DENSIFY_STREAM, state.alive.device,
                              mesh.gauss_index)
        n1, n2 = noise if noise is not None else (None, None)
        with torch.no_grad():
            params, alive, changed, adc, stats = adc_densify(
                cfg.adc, state.params, state.alive, state.adc, scene_extent,
                size_pruning_active, generator=gen, noise1=n1, noise2=n2)
            adam = zero_slots(state.adam, changed)
            stats = _sum_stats(stats, mesh)
        return TrainState(params=params, alive=alive, adam=adam, adc=adc,
                          key=state.key), stats

    return densify


def make_dist_relocate_step(cfg, mesh: Mesh, scene_extent: float):
    """An MCMC event on this shard: dist_relocate, then dist_grow when
    grow_factor > 0, both with global sources; the moments of the slots
    either changed zeroed; stats summed over the gauss group. draws: the
    (relocate, grow) draws in place of the shard's."""
    from tpugs_torch.train.trainer import (RELOCATE_STREAM, TrainState,
                                           event_generator)

    def reloc(state, draws=(None, None)):
        gen = event_generator(state.key, RELOCATE_STREAM, state.alive.device,
                              mesh.gauss_index)
        with torch.no_grad():
            params, changed, stats = dist_relocate(
                cfg.mcmc, state.params, state.alive, scene_extent, mesh, gen,
                draws[0])
            alive = state.alive
            if cfg.mcmc.grow_factor > 0:
                params, alive, grown, n_new = dist_grow(
                    cfg.mcmc, params, alive, scene_extent, mesh, gen,
                    draws[1])
                changed = changed | grown
                stats = dict(stats, num_added=n_new)
            adam = zero_slots(state.adam, changed)
            stats = _sum_stats(stats, mesh)
        return TrainState(params=params, alive=alive, adam=adam,
                          adc=state.adc, key=state.key), stats

    return reloc

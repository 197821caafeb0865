"""MCMC's relocation and growth on a gaussian-sharded mesh, as
tpugs/parallel/dist_mcmc.py: the sources follow the opacity-weighted
global multinomial the single-device events draw, whatever the shards
hold, and the grant follows global slot order. All collectives run over
the gauss group:

  1. the shards' living opacity masses are gathered; each granted target
     draws a source shard from them (a categorical, by inverse CDF in
     float64 over the G masses);
  2. every shard draws C candidates from its own opacity CDF for every
     destination shard (densify_mcmc.sample_sources: float64 sums, PR
     10's rule); the gathered count matrix says how many of each pool are
     used, so a source shard knows its copy counts for the exact
     relocation correction without another round trip;
  3. one all_to_all ships the (corrected) source rows; the j-th target
     that chose shard s copies the j-th candidate of s's pool.

Shard choice proportional to shard mass, then a source proportional to
opacity within the shard, is the global multinomial: P(k) = (M_s / M)
(o_k / M_s) = o_k / M. C covers the worst case (all of a shard's grant
from one source shard), so nothing is dropped.

Draws come from `generator` (seeded per shard by the caller: the gauss
index is folded in, so the data rows draw the same bits) in the order
shard choice [Nc], candidates [G * C], jitter [Nc, 3], or are passed in
`draws` ({"shard", "u", "jitter"}), as tests pass tpugs' draws.
"""
from __future__ import annotations

import math

import torch

from tpugs_torch.optim.densify_adc import scatter_rows
from tpugs_torch.optim.densify_mcmc import (LOG_RELOCATE_SCALE_SHRINK,
                                            RELOCATE_OPACITY, MCMCConfig,
                                            _opacity, relocation_correction,
                                            sample_sources)
from tpugs_torch.parallel import comm
from tpugs_torch.parallel.mesh import Mesh


def candidate_capacity(nc_local: int, g: int, frac: float) -> int:
    """Candidates per (source, destination) pair: the worst case, all of a
    shard's grant drawn from one source shard."""
    return max(1, min(nc_local, int(math.ceil(frac * g * nc_local))))


def _shard_choice(masses: torch.Tensor, k: int, generator=None, u=None):
    """k source shards drawn with probability proportional to their masses
    (inverse CDF in float64; a zero-mass shard is never drawn)."""
    cdf = torch.cumsum(masses.to(torch.float64), 0)
    if u is None:
        u = torch.rand((k,), generator=generator, device=masses.device,
                       dtype=torch.float64)
    idx = torch.searchsorted(cdf, u.to(torch.float64) * cdf[-1], right=True)
    return torch.clamp(idx, 0, masses.shape[0] - 1)


def _global_place(cfg: MCMCConfig, params: dict, living, opac, slot_order,
                  grant, mesh: Mesh, frac: float, scene_extent: float,
                  generator=None, draws=None):
    """Copy globally drawn sources into this shard's granted target slots
    (slot_order's first sum(grant) entries). Returns (params, changed)."""
    draws = draws or {}
    nc = living.shape[0]
    g, my = mesh.gauss, mesh.gauss_index
    dev = living.device
    c = candidate_capacity(nc, g, frac)

    # (1) Destination side: a source shard per target, by shard mass.
    mass_loc = torch.sum(torch.where(living, opac, torch.zeros_like(opac)))
    masses = comm.all_gather(mass_loc[None], mesh, "gauss")  # [G]
    s = draws.get("shard")
    if s is None:
        s = _shard_choice(masses, nc, generator)
    s = torch.as_tensor(s, device=dev).to(torch.int64)
    onehot = (s[:, None] == torch.arange(g, device=dev)[None, :]) & grant[:, None]
    cum = torch.cumsum(onehot.to(torch.int32), dim=0)  # [Nc, G]
    counts_my = cum[-1]  # granted targets per source shard
    rank = torch.gather(cum, 1, s[:, None])[:, 0].to(torch.int64) - 1
    cmat = comm.all_gather(counts_my[None], mesh, "gauss")  # [G_dst, G_src]

    # (2) Source side: candidate pools and the copy counts they imply.
    u = draws.get("u")
    cand = sample_sources(opac, living, g * c, generator,
                          None if u is None else
                          torch.as_tensor(u, device=dev).reshape(-1))
    cand = cand.reshape(g, c)
    used = (torch.arange(c, device=dev)[None, :]
            < cmat[:, my].to(torch.int64)[:, None])
    extra = torch.zeros((nc + 1,), dtype=torch.int32, device=dev)
    src_used = torch.where(used, cand, torch.full_like(cand, nc)).reshape(-1)
    extra.index_add_(0, src_used, torch.ones_like(src_used, dtype=torch.int32))
    extra = extra[:nc]
    if cfg.exact_relocation:
        new_op, new_sc = relocation_correction(
            opac, torch.exp(params["log_scales"]), 1 + extra,
            cfg.relocation_n_max)
        new_logit = torch.log(new_op) - torch.log1p(-new_op)
        new_logsc = torch.log(torch.clamp(new_sc, min=1e-30))
        touched = living & (extra > 0)
        op_col = torch.where(touched, new_logit, params["opacity_logits"])
        sc_rows = torch.where(touched[:, None], new_logsc,
                              params["log_scales"])
    else:
        touched = torch.zeros((nc,), dtype=torch.bool, device=dev)
        op_col, sc_rows = params["opacity_logits"], params["log_scales"]

    # (3) Ship the (corrected) source rows; targets become exact copies.
    sh_flat = params["sh"].reshape(nc, -1)
    k3 = sh_flat.shape[1]
    tab = torch.cat([params["means"], params["quats"], sh_flat,
                     op_col[:, None], sc_rows], dim=1)  # [Nc, 11 + k3]
    recv = comm.all_to_all(tab[cand], mesh, "gauss")  # [G, C, A]
    flat = recv.reshape(g * c, tab.shape[1])
    take = flat[torch.clamp(s * c + rank, 0, g * c - 1)]

    targets = torch.where(grant, slot_order, torch.full_like(slot_order, nc))
    out = dict(params)
    out["sh"] = scatter_rows(params["sh"], targets,
                             take[:, 7:7 + k3].reshape(params["sh"].shape))
    out["quats"] = scatter_rows(params["quats"], targets, take[:, 3:7])
    if cfg.exact_relocation:
        out["means"] = scatter_rows(params["means"], targets, take[:, 0:3])
        out["opacity_logits"] = scatter_rows(op_col, targets, take[:, 7 + k3])
        out["log_scales"] = scatter_rows(sc_rows, targets,
                                         take[:, 8 + k3:11 + k3])
    else:
        jitter = draws.get("jitter")
        if jitter is None:
            jitter = torch.randn((nc, 3), generator=generator, device=dev)
        jitter = torch.as_tensor(jitter, device=dev) * (0.01 * scene_extent)
        out["means"] = scatter_rows(params["means"], targets,
                                    take[:, 0:3] + jitter)
        out["log_scales"] = scatter_rows(
            params["log_scales"], targets,
            take[:, 8 + k3:11 + k3] - LOG_RELOCATE_SCALE_SHRINK)
        out["opacity_logits"] = scatter_rows(
            params["opacity_logits"], targets,
            torch.full((nc,), RELOCATE_OPACITY, device=dev))
    written = scatter_rows(torch.zeros((nc,), dtype=torch.bool, device=dev),
                           targets, torch.ones((nc,), dtype=torch.bool,
                                               device=dev))
    return out, touched | written


def _shard_grant(local_count, n_global, mesh: Mesh):
    """A global grant allotted in global slot order: this shard's share is
    n_global less the count on the shards before it, clipped to
    [0, local_count]."""
    counts = comm.all_gather(local_count.reshape(1), mesh, "gauss")
    before = torch.sum(counts[:mesh.gauss_index])
    return torch.clamp(n_global - before, min=0).minimum(local_count)


def dist_relocate(cfg: MCMCConfig, params: dict, alive, scene_extent: float,
                  mesh: Mesh, generator=None, draws=None):
    """A relocation event on this shard, densify_mcmc.relocate's contract
    with global sources and a global grant. Stats are this shard's counts
    (callers sum them over the gauss group)."""
    nc = alive.shape[0]
    i32 = torch.int32
    opac = _opacity(params)
    dead = alive & (opac < cfg.dead_opacity_threshold)
    living = alive & ~dead
    n_alive_loc = torch.sum(alive.to(i32))
    n_dead_loc = torch.sum(dead.to(i32))
    n_total_g, n_living_g, n_dead_g = comm.all_reduce(
        torch.stack([n_alive_loc, torch.sum(living.to(i32)), n_dead_loc]),
        mesh, "gauss")
    cap = (cfg.relocate_cap * n_total_g.to(torch.float32)).to(i32)
    n_rel_g = torch.minimum(n_dead_g, cap)
    n_rel_g = torch.where((n_dead_g == 0) | (n_living_g == 0),
                          torch.zeros_like(n_rel_g), n_rel_g)
    t = _shard_grant(n_dead_loc, n_rel_g, mesh)
    dead_order = torch.argsort(torch.where(dead, 0, 1), stable=True)
    grant = torch.arange(nc, device=alive.device) < t
    out, changed = _global_place(cfg, params, living, opac, dead_order, grant,
                                 mesh, cfg.relocate_cap, scene_extent,
                                 generator, draws)
    stats = {"num_relocated": t, "num_dead": n_dead_loc,
             "num_total": n_alive_loc}
    return out, changed, stats


def dist_grow(cfg: MCMCConfig, params: dict, alive, scene_extent: float,
              mesh: Mesh, generator=None, draws=None):
    """A growth event on this shard (global sources, the global budget
    allotted to free slots in global order), densify_mcmc.grow's contract:
    (params, alive, changed, this shard's num_added)."""
    nc = alive.shape[0]
    i32 = torch.int32
    opac = _opacity(params)
    living = alive & (opac >= cfg.dead_opacity_threshold)
    n_alive_loc = torch.sum(alive.to(i32))
    n_free_loc = nc - n_alive_loc
    n_alive_g, n_free_g, n_living_g = comm.all_reduce(
        torch.stack([n_alive_loc, n_free_loc, torch.sum(living.to(i32))]),
        mesh, "gauss")
    n_new_g = torch.minimum(
        (cfg.grow_factor * n_alive_g.to(torch.float32)).to(i32), n_free_g)
    n_new_g = torch.where(n_living_g == 0, torch.zeros_like(n_new_g), n_new_g)
    t = _shard_grant(n_free_loc, n_new_g, mesh)
    free_order = torch.argsort(torch.where(alive, 1, 0), stable=True)
    grant = torch.arange(nc, device=alive.device) < t
    out, changed = _global_place(cfg, params, living, opac, free_order, grant,
                                 mesh, cfg.grow_factor, scene_extent,
                                 generator, draws)
    targets = torch.where(grant, free_order, torch.full_like(free_order, nc))
    written = scatter_rows(torch.zeros((nc,), dtype=torch.bool,
                                       device=alive.device),
                           targets, torch.ones((nc,), dtype=torch.bool,
                                               device=alive.device))
    return out, alive | written, changed | written, t

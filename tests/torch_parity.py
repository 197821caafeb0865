"""Shared helpers for the tests that hold tpugs_torch against tpugs: the same
numpy inputs go to a JAX function and to its PyTorch counterpart, and the
outputs come back as numpy. JAX is imported only where a helper needs it,
so the card-only tests can use the rest where JAX is not installed."""
from __future__ import annotations

import numpy as np
import torch

from tpugs_torch.ops.projection import ProjectionOutput as TorchProjection

PROJ_FIELDS = ("means2d", "depths", "conic", "radii", "rgb", "opac", "visible")
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def np_(x) -> np.ndarray:
    """A JAX array or a tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def random_projection(n: int, w: int, h: int, seed: int, big_rects=False,
                      ties=True) -> dict[str, np.ndarray]:
    """Screen-space gaussians as numpy, as tests/test_expand_pallas.py draws
    them: some off screen, some invisible, some with equal depths."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-10, [w + 10, h + 10], (n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 20, n).astype(np.float32)
    if ties:
        depths[50:60] = depths[40]
    conic = np.abs(rng.normal(0.1, 0.05, (n, 3))).astype(np.float32)
    conic[:, 1] *= 0.1
    visible = rng.uniform(0, 1, n) > 0.1
    hi = 80 if big_rects else 25
    radii = np.where(visible, rng.integers(1, hi, n), 0).astype(np.int32)
    return dict(
        means2d=means2d, depths=depths, conic=conic, radii=radii,
        rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opac=rng.uniform(0.05, 0.95, n).astype(np.float32),
        visible=visible,
    )


def jax_projection(d: dict[str, np.ndarray]):
    import jax.numpy as jnp

    from tpugs.ops.projection import ProjectionOutput

    return ProjectionOutput(**{k: jnp.asarray(d[k]) for k in PROJ_FIELDS})


def torch_projection(d: dict[str, np.ndarray]) -> TorchProjection:
    return TorchProjection(**{k: torch.from_numpy(np.array(d[k])) for k in PROJ_FIELDS})


def segments(b, num_tiles: int) -> list[np.ndarray]:
    """Per-tile pair_gauss runs of a binning result (either package)."""
    ts, te, g = np_(b.tile_start), np_(b.tile_stop), np_(b.pair_gauss)
    return [g[ts[t]:te[t]] for t in range(num_tiles)]


def assert_segments_equal(b_ref, b_new, num_tiles: int):
    for t, (a, b) in enumerate(zip(segments(b_ref, num_tiles),
                                   segments(b_new, num_tiles))):
        np.testing.assert_array_equal(a, b, err_msg=f"tile {t}")
    assert int(b_ref.num_pairs) == int(b_new.num_pairs)
    assert bool(b_ref.overflow) == bool(b_new.overflow)


def assert_grads_close(got: dict, ref: dict, rtol: float = 1e-4,
                       atol_rel: float = 2e-5):
    """Every group of `got` finite, of ref's shape and within rtol |ref| +
    atol_rel max|ref| of it (the render gradients' rule: the packages add
    a gaussian's pairs in different orders)."""
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        assert np.isfinite(g).all(), f"{k}: not finite"
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol_rel * scale,
                                   err_msg=k)


def render_grads_both(p, alive, vm, intr, w, h, tile, presort, cap=8192,
                      max_hits=512, seed=0, compositor="kernel", **render_kw):
    """render()'s gradients in both packages under one seeded cotangent of
    color and final_T, for every parameter, the screen-space probe and the
    background. render_kw (need_grads, carry_attrs) go to both renders;
    compositor "kernel" renders tpugs with compositor="pallas", "scan" both
    with "scan". Returns (port output, tpugs output, port gradients, tpugs
    gradients), gradients as numpy dicts."""
    import jax
    import jax.numpy as jnp

    from tpugs.ops.render import RasterConfig as JaxConfig
    from tpugs.ops.render import render as jax_render
    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops.render import RasterConfig, render

    n = p["means"].shape[0]
    rng = np.random.default_rng(seed + 7)
    c_col = rng.normal(size=(h, w, 3)).astype(np.float32)
    c_t = rng.normal(size=(h, w)).astype(np.float32)
    bg = np.float32([0.1, 0.2, 0.3])

    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    probe = torch.zeros((n, 2), requires_grad=True)
    tbg = torch.from_numpy(bg).requires_grad_(True)
    out = render(*[tp[k] for k in NAMES], torch.from_numpy(alive),
                 torch.from_numpy(vm), torch.from_numpy(intr),
                 RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                              pair_capacity=cap, max_hits_per_tile=max_hits),
                 3, tbg, means2d_probe=probe, compositor=compositor,
                 presort=presort, **render_kw)
    loss = ((out.color * torch.from_numpy(c_col)).sum()
            + (out.final_T * torch.from_numpy(c_t)).sum())
    gs = torch.autograd.grad(loss, [tp[k] for k in NAMES] + [probe, tbg])
    got = dict(zip(NAMES + ("probe", "bg"), [np_(g) for g in gs]))

    jcfg = JaxConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                     pair_capacity=cap, max_hits_per_tile=max_hits)

    def jloss(params, probe, bgv):
        o = jax_render(*[params[k] for k in NAMES], jnp.asarray(alive),
                       jnp.asarray(vm), jnp.asarray(intr), jcfg, 3, bgv,
                       means2d_probe=probe,
                       compositor="scan" if compositor == "scan" else "pallas",
                       presort=presort, **render_kw)
        return jnp.sum(o.color * c_col) + jnp.sum(o.final_T * c_t), o

    jp = {k: jnp.asarray(p[k]) for k in NAMES}
    (_, jo), (jg, jprobe, jbg) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jp, jnp.zeros((n, 2)), jnp.asarray(bg))
    ref = {k: np.asarray(jg[k]) for k in NAMES}
    ref["probe"], ref["bg"] = np.asarray(jprobe), np.asarray(jbg)
    return out, jo, got, ref

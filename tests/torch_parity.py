"""Shared helpers for the tests that hold tpugs_torch against tpugs: the same
numpy inputs go to a JAX function and to its PyTorch counterpart, and the
outputs come back as numpy. JAX is imported only where a helper needs it,
so the card-only tests can use the rest where JAX is not installed."""
from __future__ import annotations

import numpy as np
import torch

from tpugs_torch.ops.projection import ProjectionOutput as TorchProjection

PROJ_FIELDS = ("means2d", "depths", "conic", "radii", "rgb", "opac", "visible")


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

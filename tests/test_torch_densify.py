"""Densification in tpugs_torch against tpugs on the same numpy inputs and
the same random draws (taken from JAX's keys and handed to the port): the
ADC and MCMC schedules, ADC's accumulation, densify event and opacity
reset, Adam's zero_slots, and MCMC's noise, regularization, relocation
correction, source sampling, relocate and grow.

Tolerances, with their reasons:
- masks (alive, changed), event stats and slot assignment: identical. The
  decisions compare float32 values that both packages compute with the
  same correctly rounded operations (divisions, sums of two terms), or
  exp and sigmoid, which differ by an ulp between XLA and torch on about
  10% of elements; each test asserts as a precondition that no value it
  decides on lies within 1e-5 (relative) of its threshold;
- copied rows (sh, quats, and the other rows a copy writes unchanged):
  identical; params through exp/log/pow: rtol 1e-6;
- adc_accumulate: rtol 1e-6 (the norm's square root), visibility exact;
- MCMC noise: rtol 1e-5, atol 1e-8 (a 3x3 product and exp summed in
  another order);
- relocation_correction: rtol 1e-6 on opacity and scale (pow and a
  [N, 51] @ [51, 51] product; 0 and 2.8e-7 measured); ratio 1
  bit-identical; relocate's and grow's corrected logits and log scales
  (log, log1p of those): rtol 2e-5, atol 1e-6;
- source CDF: rtol 1e-6 (the cumsums associate differently; 2.1e-7
  measured); sampled indices equal except where u * total lies within
  that rounding of an interval's edge, which are counted and bounded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import np_
from tpugs.optim import adam as JA
from tpugs.optim import densify_adc as JD
from tpugs.optim import densify_mcmc as JM
from tpugs.train import trainer as JT
from tpugs_torch.core.gaussians import train_state_from_numpy
from tpugs_torch.optim import adam as TA
from tpugs_torch.optim import densify_adc as TD
from tpugs_torch.optim import densify_mcmc as TM
from tpugs_torch.train import trainer as TT

torch.set_num_threads(1)

NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
EXTENT = 2.0
MARGIN = 1e-5


def _params(nc: int, seed: int, sh_coeffs: int = 4) -> dict:
    """Random capacity-padded parameters as numpy for the densify tests:
    scales around ADC's clone/split boundary, opacities on both sides of
    the prune and dead thresholds."""
    rng = np.random.default_rng(seed)
    return {
        "means": rng.normal(size=(nc, 3)).astype(np.float32),
        "quats": rng.normal(size=(nc, 4)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.002, 0.03, (nc, 3))).astype(np.float32),
        "opacity_logits": rng.uniform(-7.0, 3.0, nc).astype(np.float32),
        "sh": rng.normal(size=(nc, 3, sh_coeffs)).astype(np.float32),
    }


def _adc_state(nc: int, seed: int, grad_hi: float = 6e-4) -> dict:
    """ADC accumulators as numpy: average gradients on both sides of 2e-4,
    screen radii on both sides of 20."""
    rng = np.random.default_rng(seed + 1)
    count = rng.integers(0, 6, nc).astype(np.float32)
    return {
        "grad_accum": (rng.uniform(0, grad_hi, nc) * count).astype(np.float32),
        "grad_count": count,
        "max_radii": rng.uniform(0, 30, nc).astype(np.float32),
    }


def _jax_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in p.items()}


def _away(x, thr, what):
    """Precondition: no value within MARGIN (relative) of its threshold."""
    x = np.asarray(x, np.float64)
    near = np.abs(x - thr) <= MARGIN * abs(thr)
    assert not near.any(), f"{what}: {int(near.sum())} values at {thr}"


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("kw", [{}, dict(densify_from=100, densify_until=3000,
                                         densify_every=50,
                                         opacity_reset_every=700)])
def test_adc_schedule_matches_jax(skip, kw):
    ours = TD.ADCConfig(skip_final_reset=skip, **kw)
    ref = JD.ADCConfig(skip_final_reset=skip, **kw)
    steps = range(0, 20001)
    assert ([ours.should_densify(s) for s in steps]
            == [ref.should_densify(s) for s in steps])
    assert ([ours.should_reset_opacity(s) for s in steps]
            == [ref.should_reset_opacity(s) for s in steps])
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)]


def test_mcmc_schedule_and_noise_scale_match_jax():
    kw = dict(relocate_from=200, relocate_until=9000, relocate_every=75)
    ours, ref = TM.MCMCConfig(**kw), JM.MCMCConfig(**kw)
    steps = range(0, 20001)
    assert ([ours.should_relocate(s) for s in steps]
            == [ref.should_relocate(s) for s in steps])
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)]
    for s in (0.0, 1.0, 500.0, 15000.0, 30000.0, 40000.0):
        np.testing.assert_allclose(np_(TM.noise_scale(s, ours)),
                                   np.asarray(JM.noise_scale(s, ref)), rtol=1e-6)


def test_constants_are_the_reference_float32_values():
    f32 = lambda x: np.float32(x)
    assert f32(TD.LOG_SPLIT_SCALE) == np.asarray(jnp.log(JD.SPLIT_SCALE_FACTOR))
    assert f32(TM.LOG_RELOCATE_SCALE_SHRINK) == np.asarray(
        jnp.log(JM.RELOCATE_SCALE_SHRINK))
    assert TD.RESET_OPACITY == JD.RESET_OPACITY == TM.RELOCATE_OPACITY


def test_adc_accumulate_matches_jax():
    nc = 200
    rng = np.random.default_rng(3)
    st = _adc_state(nc, 3)
    d = rng.normal(0, 1e-5, (nc, 2)).astype(np.float32)
    radii = np.where(rng.uniform(size=nc) < 0.3, 0,
                     rng.integers(1, 40, nc)).astype(np.int32)
    scale = np.float32([648.5, 420.0])
    ref = JD.adc_accumulate(JD.ADCState(**_jax_params(st)), jnp.asarray(d),
                            jnp.asarray(radii), jnp.asarray(scale))
    got = TD.adc_accumulate(TD.ADCState(**_torch(st)), torch.from_numpy(d),
                            torch.from_numpy(radii), torch.from_numpy(scale))
    np.testing.assert_allclose(np_(got.grad_accum), np.asarray(ref.grad_accum),
                               rtol=1e-6)
    np.testing.assert_array_equal(np_(got.grad_count), np.asarray(ref.grad_count))
    np.testing.assert_array_equal(np_(got.max_radii), np.asarray(ref.max_radii))


def _densify_case(case):
    """(nc, params, alive, adc state, config kwargs, size_pruning_active)."""
    nc = 96
    p = _params(nc, 10)
    st = _adc_state(nc, 10)
    alive = np.arange(nc) < 40
    kw = {}
    if case == "budget":  # more clone candidates than free slots
        alive = np.arange(nc) < nc - 6
        p["opacity_logits"][:] = np.abs(p["opacity_logits"])  # nothing pruned
        kw = dict(percent_dense=1.0)  # every candidate clones
    elif case == "headroom":
        kw = dict(max_gaussians=45)
    elif case == "none":
        st["grad_accum"][:] = 0.0
    elif case == "full":  # every slot alive and kept: no free slot
        alive = np.ones(nc, bool)
        p["opacity_logits"][:] = np.abs(p["opacity_logits"])
    return nc, p, alive, st, kw


@pytest.mark.parametrize("case,pruning", [
    ("free", False), ("free", True), ("budget", False), ("headroom", True),
    ("none", False), ("full", False)])
def test_adc_densify_matches_jax(case, pruning):
    nc, p, alive, st, kw = _densify_case(case)
    ref_cfg, cfg = JD.ADCConfig(**kw), TD.ADCConfig(**kw)
    avg = st["grad_accum"] / np.maximum(st["grad_count"], np.float32(1))
    _away(avg[alive], cfg.grad_threshold, "avg_grad")
    max_scale = np.exp(p["log_scales"].astype(np.float64)).max(-1)
    _away(max_scale, cfg.percent_dense * EXTENT, "max scale")
    _away(max_scale, TD.WS_PRUNE_FRACTION * EXTENT, "world size")
    _away(1 / (1 + np.exp(-p["opacity_logits"].astype(np.float64))),
          cfg.opacity_threshold, "opacity")

    key = jax.random.PRNGKey(7)
    jp, ja, jchg, _, jstats = JD.adc_densify(
        ref_cfg, _jax_params(p), jnp.asarray(alive),
        JD.ADCState(**_jax_params(st)), key, EXTENT, pruning)
    k1, k2 = jax.random.split(key)
    n1 = np.array(jax.random.normal(k1, (nc, 3)))
    n2 = np.array(jax.random.normal(k2, (nc, 3)))
    tp, ta, tchg, tadc, tstats = TD.adc_densify(
        cfg, _torch(p), torch.from_numpy(alive), TD.ADCState(**_torch(st)),
        EXTENT, pruning, noise1=torch.from_numpy(n1),
        noise2=torch.from_numpy(n2))

    stats = {k: int(v) for k, v in tstats.items()}
    assert stats == {k: int(v) for k, v in jstats.items()}
    np.testing.assert_array_equal(np_(ta), np.asarray(ja))
    np.testing.assert_array_equal(np_(tchg), np.asarray(jchg))
    for k in ("quats", "sh", "opacity_logits"):  # copied rows
        np.testing.assert_array_equal(np_(tp[k]), np.asarray(jp[k]), err_msg=k)
    for k in ("means", "log_scales"):
        np.testing.assert_allclose(np_(tp[k]), np.asarray(jp[k]), rtol=1e-6,
                                   err_msg=k)
    assert not any(np_(v).any() for v in vars(tadc).values())
    if case == "free":
        assert stats["num_cloned"] > 0 and stats["num_split"] > 0
        assert stats["num_pruned"] > 0 or not pruning
    if case == "budget":
        free = nc - alive.sum()
        assert stats["num_cloned"] == free and stats["num_split"] == 0
    if case == "headroom":
        assert stats["num_after"] <= 45 + stats["num_split"] + 40
        assert stats["num_cloned"] + stats["num_split"] == 5
    if case in ("none", "full"):
        assert stats["num_cloned"] == stats["num_split"] == 0


def _train_state(nc, seed):
    """A JAX TrainState with nonzero moments and its leaves as the flat
    numpy dict that train_state_from_numpy takes."""
    p = _params(nc, seed)
    rng = np.random.default_rng(seed + 5)
    m = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    v = {k: rng.uniform(0, 1, v.shape).astype(np.float32) for k, v in p.items()}
    st = _adc_state(nc, seed)
    alive = rng.uniform(size=nc) < 0.7
    jstate = JT.TrainState(
        params=_jax_params(p), alive=jnp.asarray(alive),
        adam=JA.AdamState(m=_jax_params(m), v=_jax_params(v),
                          count=jnp.asarray(5, jnp.int32)),
        adc=JD.ADCState(**_jax_params(st)), key=jax.random.PRNGKey(seed))
    flat = {f"params/{k}": a for k, a in p.items()}
    flat.update({f"adam_m/{k}": a for k, a in m.items()})
    flat.update({f"adam_v/{k}": a for k, a in v.items()})
    flat.update(alive=alive, adam_count=np.int32(5), key=TT.initial_key(seed),
                **{f"adc_{k}": a for k, a in st.items()})
    return jstate, flat


def _assert_states_equal(got, ref):
    for k in NAMES:
        np.testing.assert_array_equal(np_(got.params[k]), np.asarray(ref.params[k]))
        np.testing.assert_array_equal(np_(got.adam.m[k]), np.asarray(ref.adam.m[k]))
        np.testing.assert_array_equal(np_(got.adam.v[k]), np.asarray(ref.adam.v[k]))
    np.testing.assert_array_equal(np_(got.alive), np.asarray(ref.alive))
    assert int(got.adam.count) == int(ref.adam.count)
    for k in ("grad_accum", "grad_count", "max_radii"):
        np.testing.assert_array_equal(np_(getattr(got.adc, k)),
                                      np.asarray(getattr(ref.adc, k)))


def test_train_state_from_numpy_round_trips_a_jax_state():
    jstate, flat = _train_state(24, 1)
    state = train_state_from_numpy(jax.tree.map(np.asarray, flat), "cpu")
    _assert_states_equal(state, jstate)
    assert state.key.dtype == np.uint32 and list(state.key) == [1, 0]
    assert all(t.device.type == "cpu" for t in state.params.values())


def test_zero_slots_and_opacity_reset_match_jax():
    jstate, flat = _train_state(24, 2)
    state = train_state_from_numpy(flat, "cpu")
    mask = np.random.default_rng(0).uniform(size=24) < 0.4
    ref = JA.zero_slots(jstate.adam, jnp.asarray(mask))
    got = TA.zero_slots(state.adam, torch.from_numpy(mask))
    for k in NAMES:
        np.testing.assert_array_equal(np_(got.m[k]), np.asarray(ref.m[k]))
        np.testing.assert_array_equal(np_(got.v[k]), np.asarray(ref.v[k]))
    _assert_states_equal(TT.reset_opacity_step(state),
                         JT._reset_opacity_impl(jstate))


def _noise_inputs(nc=64, seed=4):
    p = _params(nc, seed)
    p["opacity_logits"] = np.random.default_rng(seed).uniform(
        2.0, 8.0, nc).astype(np.float32)  # around the gate at 0.995
    alive = np.arange(nc) < nc - 5
    return p, alive


@pytest.mark.parametrize("kw,step", [
    ({}, 100.0),  # clamped
    (dict(noise_max_sigma=1e9), 100.0),  # clamp never reached
    (dict(noise_clamp_until=50), 100.0),  # clamp released
    (dict(noise_clamp_until=500), 100.0),
    ({}, 16000.0),  # past relocate_until: no noise
])
def test_inject_noise_matches_jax(kw, step):
    p, alive = _noise_inputs()
    key = jax.random.PRNGKey(3)
    ref = JM.inject_noise(JM.MCMCConfig(**kw), _jax_params(p),
                          jnp.asarray(alive), jnp.float32(step), key)
    normal = np.array(jax.random.normal(key, p["means"].shape))
    got = TM.inject_noise(TM.MCMCConfig(**kw), _torch(p),
                          torch.from_numpy(alive), step,
                          normal=torch.from_numpy(normal))
    np.testing.assert_allclose(np_(got["means"]), np.asarray(ref["means"]),
                               rtol=1e-5, atol=1e-8)
    moved = np.abs(np_(got["means"]) - p["means"]).max(-1)
    assert not moved[~alive].any()
    if step < 15000:
        assert moved.max() > 0
    for k in NAMES[1:]:
        assert np_(got[k]) is not None and np.array_equal(np_(got[k]), p[k])


def test_regularization_and_gradient_match_jax():
    p, alive = _noise_inputs()
    cfg, ref_cfg = TM.MCMCConfig(), JM.MCMCConfig()
    jval, jg = jax.value_and_grad(
        lambda q: JM.regularization(ref_cfg, q, jnp.asarray(alive)))(
            _jax_params(p))
    tp = {k: v.requires_grad_(True) for k, v in _torch(p).items()}
    val = TM.regularization(cfg, tp, torch.from_numpy(alive))
    grads = torch.autograd.grad(val, [tp["opacity_logits"], tp["log_scales"]])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(np_(grads[0]), np.asarray(jg["opacity_logits"]),
                               rtol=1e-5)
    np.testing.assert_allclose(np_(grads[1]), np.asarray(jg["log_scales"]),
                               rtol=1e-5)


def test_relocation_correction_matches_jax():
    rng = np.random.default_rng(5)
    n = 51 * 4
    opac = rng.uniform(0.006, 0.999, n).astype(np.float32)
    scales = rng.uniform(0.001, 0.1, (n, 3)).astype(np.float32)
    ratio = np.tile(np.arange(1, 52, dtype=np.int32), 4)
    jo, js = JM.relocation_correction(jnp.asarray(opac), jnp.asarray(scales),
                                      jnp.asarray(ratio))
    to, ts = TM.relocation_correction(torch.from_numpy(opac),
                                      torch.from_numpy(scales),
                                      torch.from_numpy(ratio))
    np.testing.assert_allclose(np_(to), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(np_(ts), np.asarray(js), rtol=1e-6)
    one = ratio == 1
    np.testing.assert_array_equal(np_(to)[one], opac[one])
    np.testing.assert_array_equal(np_(ts)[one], scales[one])
    assert (np_(to)[~one] < opac[~one]).all()


def _jax_cdf(opac, living):
    """The reference's two-level CDF (tpugs/optim/densify_mcmc.py
    sample_sources), which the reference does not return."""
    w = jnp.where(living, opac, 0.0).astype(jnp.float32)
    nc = w.shape[0]
    nb = min(1024, nc)
    npad = -(-nc // nb) * nb
    wpad = jnp.pad(w, (0, npad - nc)).reshape(npad // nb, nb)
    within = jnp.cumsum(wpad, axis=1)
    block_tot = within[:, -1]
    offs = jnp.cumsum(block_tot) - block_tot
    return np.asarray((within + offs[:, None]).reshape(-1))[:nc]


def test_sample_sources_matches_jax():
    nc = 3000  # three blocks of the two-level CDF, the last one padded
    rng = np.random.default_rng(6)
    opac = rng.uniform(0, 1, nc).astype(np.float32)
    living = rng.uniform(size=nc) < 0.8
    key = jax.random.PRNGKey(11)
    ref = np.asarray(JM.sample_sources(key, jnp.asarray(opac),
                                       jnp.asarray(living), (nc,)))
    u = np.array(jax.random.uniform(key, (nc,), dtype=jnp.float32))
    c_ref = _jax_cdf(jnp.asarray(opac), jnp.asarray(living))
    c = np_(TM.source_cdf(torch.from_numpy(opac), torch.from_numpy(living)))
    np.testing.assert_allclose(c, c_ref, rtol=1e-6)
    got = np_(TM.sample_sources(torch.from_numpy(opac), torch.from_numpy(living),
                                nc, u=torch.from_numpy(u)))
    differ = np.nonzero(got != ref)[0]
    # A differing draw must sit within the CDFs' rounding of an edge.
    x = u[differ].astype(np.float64) * c_ref[-1]
    edge = c_ref[np.minimum(ref[differ], got[differ])]
    assert (np.abs(x - edge) <= 1e-6 * c_ref[-1]).all()
    assert len(differ) <= 3, len(differ)
    assert living[got].all()


def _mcmc_inputs(nc=128, seed=8, n_alive=100):
    p = _params(nc, seed)
    p["opacity_logits"] = np.random.default_rng(seed).uniform(
        -9.0, 3.0, nc).astype(np.float32)
    alive = np.arange(nc) < n_alive
    return p, alive


def _jax_draws(key, nc):
    """The (u, jitter) that relocate / grow draw from `key`."""
    k_src, k_jit = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k_src, (nc,)))),
            torch.from_numpy(np.array(jax.random.normal(k_jit, (nc, 3)))))


def _assert_placed(got, ref, exact: bool):
    for k in ("sh", "quats") + (("means",) if exact else ()):
        np.testing.assert_array_equal(np_(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("opacity_logits", "log_scales") + (() if exact else ("means",)):
        np.testing.assert_allclose(np_(got[k]), np.asarray(ref[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("exact", [True, False])
def test_relocate_matches_jax(exact):
    p, alive = _mcmc_inputs()
    cfg = TM.MCMCConfig(exact_relocation=exact)
    ref_cfg = JM.MCMCConfig(exact_relocation=exact)
    _away(1 / (1 + np.exp(-p["opacity_logits"].astype(np.float64))),
          cfg.dead_opacity_threshold, "opacity")
    key = jax.random.PRNGKey(9)
    jp, jchg, jstats = JM.relocate(ref_cfg, _jax_params(p), jnp.asarray(alive),
                                   key, EXTENT)
    u, jit = _jax_draws(key, len(alive))
    tp, tchg, tstats = TM.relocate(cfg, _torch(p), torch.from_numpy(alive),
                                   EXTENT, u=u, jitter=jit)
    stats = {k: int(v) for k, v in tstats.items()}
    assert stats == {k: int(v) for k, v in jstats.items()}
    assert 0 < stats["num_relocated"] < stats["num_dead"]  # capped at 5%
    np.testing.assert_array_equal(np_(tchg), np.asarray(jchg))
    _assert_placed(tp, jp, exact)


@pytest.mark.parametrize("max_gaussians", [0, 103])
def test_grow_matches_jax(max_gaussians):
    p, alive = _mcmc_inputs()
    key = jax.random.PRNGKey(12)
    jp, ja, jchg, jn = JM.grow(JM.MCMCConfig(), _jax_params(p),
                               jnp.asarray(alive), key, EXTENT, max_gaussians)
    u, jit = _jax_draws(key, len(alive))
    tp, ta, tchg, tn = TM.grow(TM.MCMCConfig(), _torch(p),
                               torch.from_numpy(alive), EXTENT, max_gaussians,
                               u=u, jitter=jit)
    assert int(tn) == int(jn) == (3 if max_gaussians else 5)
    np.testing.assert_array_equal(np_(ta), np.asarray(ja))
    np.testing.assert_array_equal(np_(tchg), np.asarray(jchg))
    _assert_placed(tp, jp, True)


def test_event_draws_follow_the_key():
    """The same key and stream draw the same; another step or stream draws
    otherwise."""
    key = TT.initial_key(5)
    draw = lambda k, s: torch.randn(4, generator=TT.event_generator(k, s, "cpu"))
    a = draw(key, TT.DENSIFY_STREAM)
    assert torch.equal(a, draw(key.copy(), TT.DENSIFY_STREAM))
    assert not torch.equal(a, draw(key, TT.RELOCATE_STREAM))
    assert not torch.equal(a, draw(key + np.asarray([0, 1], np.uint32),
                                   TT.DENSIFY_STREAM))

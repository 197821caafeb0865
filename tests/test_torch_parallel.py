"""tpugs_torch/parallel against tpugs/parallel: slice binning, the
exchange's send index, the tile-sharded forward and its gradients, the
three one-step trainers, the distributed ADC densify and MCMC events and
the communication report.

tpugs runs on the conftest's 8 virtual CPU devices (a mesh of 4 of them
where the port has 4 ranks); the port runs one gloo world of 4 spawned
CPU ranks (tests/torch_dist.py) that builds the meshes 1x4, 2x2 and 4x1.
The scene is tests/test_parallel.py's: 64x48, tiles of 16, 64 gaussians,
SH 1. Tolerances, tpugs' own unless said:
- slice binning, send index, densify decisions, stats and slot
  assignment: identical;
- colour: within ULP2 = 5e-7 of tpugs' tile-sharded forward and of the
  port's own single-device render (tests/test_parallel.py's bound);
- raw gradients after normalisation: loss rtol 1e-5, gradients rtol 2e-5,
  atol 1e-8 (test_parallel.py's);
- one train step: loss rtol 1e-5, params atol 2e-6 (test_parallel.py's);
- MCMC events: copies exact, corrected logits and log scales rtol 2e-5,
  atol 1e-6, and at most 3 candidates that differ at an edge of the
  source CDF (tests/test_torch_densify.py's rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.test_parallel import (CFG, _tile_shard_forward, _tile_shard_grads,
                                 reference_grads)
from tests.torch_dist import run_world
from tests.torch_parity import (assert_segments_equal, jax_projection, np_,
                                random_projection, torch_projection)
from tpugs.ops import binning as JB
from tpugs.optim.adam import AdamConfig as JaxAdam
from tpugs.optim.adam import adam_init as jax_adam_init
from tpugs.parallel import tile_shard as JS
from tpugs.parallel.mesh import make_mesh as jax_mesh
from tpugs.utils.synthetic import synthetic_intrinsics, synthetic_params
from tpugs_torch.ops import binning as TB
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.parallel import dist_train as TDT
from tpugs_torch.parallel import tile_shard as TS
from tpugs_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

ULP2 = 5e-7
N = 64
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
EXTENT = 2.0
MARGIN = 1e-5
W, H = CFG.img_w, CFG.img_h


def _jmesh(d, g):
    return jax_mesh(axis_sizes=(d, g), devices=jax.devices()[: d * g])


# --- slice binning (in-process, K1's plain version) -----------------------

SLICE_W, SLICE_H, SLICE_TILE, SLICE_CAP = 128, 96, 16, 8192  # 6 tile rows


@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("presorted", [False, True])
def test_slice_binning_matches_jax(rows, presorted):
    d = random_projection(300, SLICE_W, SLICE_H, 5, big_rects=True)
    jp, tp = jax_projection(d), torch_projection(d)
    if presorted:
        jp, tp = JB.presort_by_depth(jp)[1], TB.presort_by_depth(tp)[1]
    nty = -(-SLICE_H // SLICE_TILE)
    nt = (-(-SLICE_W // SLICE_TILE)) * rows
    args = (SLICE_W, SLICE_H, SLICE_TILE, SLICE_TILE, SLICE_CAP)
    for lo in range(0, nty, rows):  # every slice, the last one padded at 4
        kw = dict(tile_row_lo=lo, num_tile_rows=rows, presorted=presorted)
        ref = JB.bin_gaussians_expand_kernel(jp, *args, interpret=True, **kw)
        got = TB.bin_gaussians_expand_kernel(tp, *args, **kw)
        assert_segments_equal(ref, got, nt)
        for f in ("tile_start", "tile_stop"):
            np.testing.assert_array_equal(np_(getattr(got, f)),
                                          np_(getattr(ref, f)), err_msg=f)
        assert_segments_equal(JB.bin_gaussians(jp, *args, **kw),
                              TB.bin_gaussians(tp, *args, **kw), nt)
        assert_segments_equal(got, TB.bin_gaussians(tp, *args, **kw), nt)
        assert int(got.num_pairs) > 0 or lo >= nty


def test_slices_partition_the_whole_frame():
    """The slices' pairs, tile ids made global again, are the whole
    frame's pairs."""
    d = random_projection(300, SLICE_W, SLICE_H, 6, big_rects=True)
    tp = TB.presort_by_depth(torch_projection(d))[1]
    args = (SLICE_W, SLICE_H, SLICE_TILE, SLICE_TILE, SLICE_CAP)
    whole = TB.bin_gaussians_expand_kernel(tp, *args, presorted=True)
    ntx = -(-SLICE_W // SLICE_TILE)
    per_tile = []
    for lo in (0, 3):
        b = TB.bin_gaussians_expand_kernel(tp, *args, presorted=True,
                                           tile_row_lo=lo, num_tile_rows=3)
        ts, te, g = np_(b.tile_start), np_(b.tile_stop), np_(b.pair_gauss)
        per_tile += [g[ts[t]:te[t]] for t in range(3 * ntx)]
    ts, te, g = (np_(whole.tile_start), np_(whole.tile_stop),
                 np_(whole.pair_gauss))
    for t, seg in enumerate(per_tile):
        np.testing.assert_array_equal(seg, g[ts[t]:te[t]], err_msg=f"tile {t}")


# --- the exchange's send index (in-process) -------------------------------

@pytest.mark.parametrize("g,capacity", [(4, 64), (4, 5), (3, 2)])
def test_destination_range_and_send_index_match_jax(g, capacity):
    d = random_projection(64, W, H, 7, big_rects=True)
    jp, tp = jax_projection(d), torch_projection(d)
    jd0, jd1 = JS.destination_range(jp, CFG, g)
    cfg = RasterConfig(img_h=H, img_w=W, tile_h=16, tile_w=16)
    td0, td1 = TS.destination_range(tp, cfg, g)
    np.testing.assert_array_equal(np_(td0), np.asarray(jd0))
    np.testing.assert_array_equal(np_(td1), np.asarray(jd1))
    jidx, jcount = JS.build_send_index(jd0, jd1, g, capacity)
    tidx, tcount = TS.build_send_index(td0, td1, g, capacity)
    np.testing.assert_array_equal(np_(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(np_(tcount), np.asarray(jcount))
    if capacity < 10:  # overflowed: the first C senders kept, none clipped
        assert (np_(tcount) > capacity).any()
        n = td0.shape[0]
        for dst in range(g):
            want = np.nonzero((np_(td0) <= dst) & (dst <= np_(td1)))[0]
            kept = np_(tidx)[dst]
            np.testing.assert_array_equal(kept[kept < n], want[:capacity])


def test_comm_report_equal():
    args = (CFG, 4, 50_000, 1664, 1200, 25_600)
    cfg = RasterConfig(img_h=H, img_w=W, tile_h=16, tile_w=16)
    assert TS.comm_report(cfg, *args[1:]) == JS.comm_report(*args)
    assert TS.EXCHANGE_ATTRS == JS.EXCHANGE_ATTRS
    assert TS.PAIR_IMBALANCE_HEADROOM == JS.PAIR_IMBALANCE_HEADROOM
    assert (TS.default_local_pair_capacity(8192, 4)
            == JS.default_local_pair_capacity(8192, 4))


# --- the mesh spec --------------------------------------------------------

def test_parse_mesh_spec_infers_one_axis():
    from tpugs.parallel.dist_train import parse_mesh_spec as jax_parse

    m = jax_parse("data=2,gauss=-1", n_devices=8)
    assert TDT.mesh_axis_sizes("data=2,gauss=-1", 8) == (
        m.shape["data"], m.shape["gauss"]) == (2, 4)
    one = TDT.parse_mesh_spec("data=1,gauss=-1", device="cpu")
    assert (one.data, one.gauss, one.rank) == (1, 1, 0)


@pytest.mark.parametrize("spec,match", [
    ("data=-1,gauss=-1", "at most one axis"),
    ("data=3,gauss=2", "axis product"),
    ("data=3,gauss=-1", "not divisible"),
    ("model=2", "unknown mesh axis"),
])
def test_parse_mesh_spec_errors_match_jax(spec, match):
    from tpugs.parallel.dist_train import parse_mesh_spec as jax_parse

    with pytest.raises(ValueError, match=match):
        jax_parse(spec, n_devices=8)
    with pytest.raises(ValueError, match=match):
        TDT.parse_mesh_spec(spec, n_devices=8, device="cpu")


def test_mesh_larger_than_the_world_names_the_launcher():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        TDT.parse_mesh_spec("data=2,gauss=2", n_devices=4, device="cpu")


# --- the 4-rank world -----------------------------------------------------

def _scene():
    params = {k: np.asarray(v) for k, v in
              synthetic_params(N, seed=0, sh_coeffs=4).items()}
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (8, H, W, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32)[None], (8, 1, 1))
    intr = np.tile(np.asarray(synthetic_intrinsics(W, H))[None], (8, 1))
    return params, np.ones(N, bool), images, viewmats, intr


def _away(x, thr, what):
    x = np.asarray(x, np.float64)
    near = np.abs(x - thr) <= MARGIN * abs(thr)
    assert not near.any(), f"{what}: {int(near.sum())} values at {thr}"


def _densify_inputs(g: int, seed: int):
    """A global ADC state over 128 slots (about half alive, scales and
    gradients on both sides of the thresholds) and tpugs' per-shard
    noise."""
    from tpugs.optim import densify_adc as JD

    nc = 128
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.normal(size=(nc, 3)).astype(np.float32),
        "quats": rng.normal(size=(nc, 4)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.002, 0.03, (nc, 3))).astype(np.float32),
        "opacity_logits": rng.uniform(-7.0, 3.0, nc).astype(np.float32),
        "sh": rng.normal(size=(nc, 3, 4)).astype(np.float32),
    }
    count = rng.integers(0, 6, nc).astype(np.float32)
    st = {"grad_accum": (rng.uniform(0, 6e-4, nc) * count).astype(np.float32),
          "grad_count": count,
          "max_radii": rng.uniform(0, 30, nc).astype(np.float32)}
    alive = rng.uniform(size=nc) < 0.5
    cfg = JD.ADCConfig()
    avg = st["grad_accum"] / np.maximum(st["grad_count"], np.float32(1))
    _away(avg[alive], cfg.grad_threshold, "avg_grad")
    max_scale = np.exp(p["log_scales"].astype(np.float64)).max(-1)
    _away(max_scale, cfg.percent_dense * EXTENT, "max scale")
    _away(max_scale, JD.WS_PRUNE_FRACTION * EXTENT, "world size")
    _away(1 / (1 + np.exp(-p["opacity_logits"].astype(np.float64))),
          cfg.opacity_threshold, "opacity")
    m = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    v2 = {k: rng.uniform(size=v.shape).astype(np.float32) for k, v in p.items()}
    flat = {f"params/{k}": v for k, v in p.items()}
    flat.update({f"adam_m/{k}": v for k, v in m.items()})
    flat.update({f"adam_v/{k}": v for k, v in v2.items()})
    flat.update(alive=alive, adam_count=np.int32(3),
                adc_grad_accum=st["grad_accum"],
                adc_grad_count=st["grad_count"],
                adc_max_radii=st["max_radii"],
                key=np.asarray([0, 0], np.uint32))
    key = jax.random.PRNGKey(seed)
    dkey = jax.random.split(key)[1]
    noise = []
    for j in range(g):
        k1, k2 = jax.random.split(jax.random.fold_in(dkey, j))
        noise.append((np.array(jax.random.normal(k1, (nc // g, 3))),
                      np.array(jax.random.normal(k2, (nc // g, 3)))))
    return flat, key, noise


def _mcmc_inputs(g: int, seed: int, exact: bool = True):
    """A global MCMC state over 128 slots with uneven opacity mass over the
    shards, and tpugs' per-shard draws of dist_relocate and dist_grow."""
    from tpugs.optim import densify_mcmc as JM
    from tpugs.parallel.dist_mcmc import candidate_capacity

    nc = 128
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.normal(size=(nc, 3)).astype(np.float32),
        "quats": rng.normal(size=(nc, 4)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.002, 0.03, (nc, 3))).astype(np.float32),
        "opacity_logits": rng.uniform(-9.0, 3.0, nc).astype(np.float32),
        "sh": rng.normal(size=(nc, 3, 4)).astype(np.float32),
    }
    p["opacity_logits"][: nc // 4] -= 4.0  # shard 0 holds little mass
    alive = rng.uniform(size=nc) < 0.8
    cfg = dict(relocate_cap=0.2, grow_factor=0.1, exact_relocation=exact)
    _away(1 / (1 + np.exp(-p["opacity_logits"].astype(np.float64))),
          JM.MCMCConfig().dead_opacity_threshold, "opacity")
    n_loc = nc // g
    keys = {"relocate": jax.random.PRNGKey(seed),
            "grow": jax.random.PRNGKey(seed + 1)}
    opac = np.asarray(jax.nn.sigmoid(jnp.asarray(p["opacity_logits"])))
    thr = JM.MCMCConfig().dead_opacity_threshold
    draws = {}
    for kind, key in keys.items():
        living = alive & (opac >= thr)
        frac = cfg["relocate_cap"] if kind == "relocate" else cfg["grow_factor"]
        c = candidate_capacity(n_loc, g, frac)
        masses = jnp.stack([jnp.sum(jnp.where(
            jnp.asarray(living[j * n_loc:(j + 1) * n_loc]),
            jnp.asarray(opac[j * n_loc:(j + 1) * n_loc]), 0.0))
            for j in range(g)])
        logits = jnp.where(masses > 0.0,
                           jnp.log(jnp.maximum(masses, 1e-30)), -1e30)
        per = []
        for j in range(g):
            f = lambda t: jax.random.fold_in(jax.random.fold_in(key, t), j)
            per.append({
                "shard": np.array(jax.random.categorical(f(1), logits,
                                                         shape=(n_loc,))),
                "u": np.array(jax.random.uniform(f(2), (g, c))),
                "jitter": np.array(jax.random.normal(f(3), (n_loc, 3))),
            })
        draws[kind] = per
    return p, alive, cfg, keys, draws


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results for every case, and the inputs."""
    params, alive, images, viewmats, intr = _scene()
    densify, mcmc = {}, {}
    for name, g, seed in (("g2", 2, 21), ("g4", 4, 22)):
        flat, key, noise = _densify_inputs(g, seed)
        densify[name] = dict(flat=flat, noise=noise, pruning=g == 4,
                             extent=EXTENT, cfg={}, jax=(key,))
    for name, g, seed, exact in (("g2", 2, 31, True), ("g4", 4, 32, True),
                                 ("g2_jitter", 2, 33, False)):
        p, a, cfg, keys, draws = _mcmc_inputs(g, seed, exact)
        mcmc[name] = dict(params=p, alive=a, draws=draws, extent=EXTENT,
                          cfg=cfg)
        mcmc[name]["jax"] = (keys,)
    cfg = dict(img_h=H, img_w=W, tile_h=16, tile_w=16,
               pair_capacity=CFG.pair_capacity,
               max_hits_per_tile=CFG.max_hits_per_tile)
    strip = lambda d: {k: {kk: vv for kk, vv in v.items() if kk != "jax"}
                       for k, v in d.items()}
    results = run_world(4, "tests.torch_dist_cases:parallel_world",
                        tmp_path_factory.mktemp("parallel"), params=params,
                        alive=alive, images=images, viewmats=viewmats,
                        intr=intr, cfg=cfg, densify=strip(densify),
                        mcmc=strip(mcmc))
    return dict(results=results, params=params, alive=alive, images=images,
                viewmats=viewmats, intr=intr, densify=densify, mcmc=mcmc)


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def test_ranks_sit_row_major(world):
    got = [r["mesh"] for r in world["results"]]
    assert got == [(0, 0, 0, 0), (0, 1, 1, 1), (1, 0, 2, 2), (1, 1, 3, 3)]


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_tile_sharded_forward_matches_jax_and_render(world, shape):
    w = world
    d, g = (int(x) for x in shape.split("x"))
    ref, diag = _tile_shard_forward(_jmesh(d, g), _jax_params(w["params"]),
                                    jnp.asarray(w["alive"]),
                                    jnp.asarray(w["viewmats"][0]),
                                    jnp.asarray(w["intr"][0]))
    cfg = RasterConfig(img_h=H, img_w=W, tile_h=16, tile_w=16,
                       pair_capacity=CFG.pair_capacity,
                       max_hits_per_tile=CFG.max_hits_per_tile)
    t = {k: torch.from_numpy(np.array(v)) for k, v in w["params"].items()}
    with torch.no_grad():
        single = render(t["means"], t["quats"], t["log_scales"],
                        t["opacity_logits"], t["sh"],
                        torch.from_numpy(w["alive"]),
                        torch.from_numpy(w["viewmats"][0]),
                        torch.from_numpy(w["intr"][0]), cfg, 1,
                        torch.zeros(3), need_grads=False).color.numpy()
    colors = [r[f"forward_{shape}"][0] for r in w["results"]]
    for c in colors[1:]:
        np.testing.assert_array_equal(c, colors[0])
    assert not any(r[f"forward_{shape}"][1] or r[f"forward_{shape}"][2]
                   for r in w["results"])
    assert not bool(diag["send_overflow"])
    np.testing.assert_allclose(colors[0], np.asarray(ref), atol=ULP2, rtol=0)
    np.testing.assert_allclose(colors[0], single, atol=ULP2, rtol=0)
    assert colors[0].max() > 0.1


def test_send_capacity_overflow_flag(world):
    assert all(r["forward_cap1"][1] for r in world["results"])


def _gathered(results, key, ranks, index=0):
    """Shards of a result (rank order within a data row) concatenated."""
    parts = [results[r][key][index] for r in ranks]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_tile_sharded_raw_gradients_match_jax(world):
    w = world
    args = (_jax_params(w["params"]), jnp.asarray(w["alive"]),
            jnp.asarray(w["images"][:2]), jnp.asarray(w["viewmats"][:2]),
            jnp.asarray(w["intr"][:2]))
    ref_grads, ref_loss = _tile_shard_grads(_jmesh(2, 2), *args)
    one_loss, one_grads = reference_grads(*args)
    res = w["results"]
    got = _gathered(res, "grads_2x2", (0, 1))
    other_row = _gathered(res, "grads_2x2", (2, 3))
    for k in NAMES:  # both data rows hold the same normalised gradient
        np.testing.assert_array_equal(got[k], other_row[k], err_msg=k)
    loss = res[0]["grads_2x2"][1]
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(loss, float(one_loss), rtol=1e-5)
    for k in NAMES:
        np.testing.assert_allclose(got[k], np.asarray(ref_grads[k]),
                                   rtol=2e-5, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(one_grads[k]),
                                   rtol=2e-5, atol=1e-8, err_msg=k)


def _jax_one_step(kind, w, d, g, b):
    from tpugs.parallel.gauss_shard import (make_gauss_sharded_train_step,
                                            shard_gauss_state)
    from tpugs.parallel.sharded_train import (make_dp_train_step, replicate,
                                              shard_batch)
    from tpugs.parallel.tile_shard import make_tile_sharded_train_step

    mesh = _jmesh(d, g)
    params = _jax_params(w["params"])
    alive = jnp.asarray(w["alive"])
    batch = (jnp.asarray(w["images"][:b]), jnp.asarray(w["viewmats"][:b]),
             jnp.asarray(w["intr"][:b]))
    if kind == "dp_step":
        step = make_dp_train_step(mesh, CFG, JaxAdam(), sh_degree=1)
        state = replicate(mesh, (params, alive, jax_adam_init(params)))
        batch = shard_batch(mesh, *batch)
    else:
        make = (make_tile_sharded_train_step if kind == "tile_step"
                else make_gauss_sharded_train_step)
        step = make(mesh, CFG, JaxAdam(), sh_degree=1, compositor="scan")
        state = shard_gauss_state(mesh, params, alive, jax_adam_init(params))
    new_params, _, loss = step(*state, *batch, jnp.zeros(()))
    return {k: np.asarray(v) for k, v in new_params.items()}, float(loss)


@pytest.mark.parametrize("kind,d,g,b", [("tile_step", 2, 2, 2),
                                        ("gauss_step", 2, 2, 2),
                                        ("dp_step", 4, 1, 8)])
def test_one_train_step_matches_jax(world, kind, d, g, b):
    ref, ref_loss = _jax_one_step(kind, world, d, g, b)
    res = world["results"]
    row = range(g)
    got = (_gathered(res, kind, row) if g > 1
           else res[0][kind][0])
    for r in res:  # every rank reports the step's loss
        np.testing.assert_allclose(r[kind][1], ref_loss, rtol=1e-5)
    for k in NAMES:
        np.testing.assert_allclose(got[k], ref[k], atol=2e-6, err_msg=k)


@pytest.mark.parametrize("name,g", [("g2", 2), ("g4", 4)])
def test_dist_densify_matches_jax(world, name, g):
    from tpugs.optim import densify_adc as JD
    from tpugs.optim.adam import AdamState
    from tpugs.parallel.dist_train import (make_dist_densify_step,
                                           shard_train_state)
    from tpugs.train.trainer import TrainConfig as JaxTrainConfig
    from tpugs.train.trainer import TrainState as JaxTrainState

    case = world["densify"][name]
    flat, (key,) = case["flat"], case["jax"]
    grp = lambda pre: {k[len(pre):]: jnp.asarray(v) for k, v in flat.items()
                       if k.startswith(pre)}
    state = JaxTrainState(
        params=grp("params/"), alive=jnp.asarray(flat["alive"]),
        adam=AdamState(m=grp("adam_m/"), v=grp("adam_v/"),
                       count=jnp.asarray(flat["adam_count"])),
        adc=JD.ADCState(grad_accum=jnp.asarray(flat["adc_grad_accum"]),
                        grad_count=jnp.asarray(flat["adc_grad_count"]),
                        max_radii=jnp.asarray(flat["adc_max_radii"])),
        key=key)
    d = 4 // g
    mesh = _jmesh(d, g)
    step = make_dist_densify_step(JaxTrainConfig(), mesh, EXTENT)
    new, jstats = step(shard_train_state(mesh, state),
                       size_pruning_active=case["pruning"])
    res = world["results"]
    stats = [r[f"densify_{name}"][1] for r in res]
    assert all(s == {k: int(v) for k, v in jstats.items()} for s in stats)
    assert stats[0]["num_cloned"] > 0 and stats[0]["num_split"] > 0
    got = {k: np.concatenate([res[r][f"densify_{name}"][0][k]
                              for r in range(g)])
           for k in flat if k not in TDT.REPLICATED}
    np.testing.assert_array_equal(got["alive"], np.asarray(new.alive))
    for k in ("quats", "sh", "opacity_logits"):  # copied rows
        np.testing.assert_array_equal(got[f"params/{k}"],
                                      np.asarray(new.params[k]), err_msg=k)
    for k in ("means", "log_scales"):
        np.testing.assert_allclose(got[f"params/{k}"],
                                   np.asarray(new.params[k]), rtol=1e-6,
                                   err_msg=k)
    for k in NAMES:  # the moments zeroed in the same slots
        np.testing.assert_array_equal(got[f"adam_m/{k}"],
                                      np.asarray(new.adam.m[k]), err_msg=k)
        np.testing.assert_array_equal(got[f"adam_v/{k}"],
                                      np.asarray(new.adam.v[k]), err_msg=k)
    for k in ("adc_grad_accum", "adc_grad_count", "adc_max_radii"):
        assert not got[k].any()


def _jax_mcmc(case, g):
    from tpugs.optim.densify_mcmc import MCMCConfig as JaxMCMC
    from tpugs.parallel.dist_mcmc import dist_grow, dist_relocate

    cfg = JaxMCMC(**case["cfg"])
    (keys,) = case["jax"]
    spec = {k: P("gauss") for k in NAMES}
    mesh = _jmesh(1, g)

    def reloc(p, a, key):
        out, changed, stats = dist_relocate(cfg, p, a, key, EXTENT, g)
        return out, changed, {k: jax.lax.psum(v, "gauss")
                              for k, v in stats.items()}

    def grow_(p, a, key):
        out, alive, changed, n = dist_grow(cfg, p, a, key, EXTENT, g)
        return out, alive, changed, jax.lax.psum(n, "gauss")

    sm = lambda f, outs: jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(spec, P("gauss"), P()), out_specs=outs,
        check_vma=False))
    args = (_jax_params(case["params"]), jnp.asarray(case["alive"]))
    r = sm(reloc, (spec, P("gauss"), P()))(*args, keys["relocate"])
    gr = sm(grow_, (spec, P("gauss"), P("gauss"), P()))(*args, keys["grow"])
    return jax.tree.map(np.asarray, r), jax.tree.map(np.asarray, gr)


def _differing_targets(got, ref, changed):
    """Changed slots whose copied rows differ: a candidate drawn on the
    other side of a source-CDF edge."""
    rows = lambda p: np.concatenate([p["quats"], p["sh"].reshape(
        p["sh"].shape[0], -1)], axis=1)
    return np.nonzero(changed & (rows(got) != rows(ref)).any(axis=1))[0]


@pytest.mark.parametrize("name,g", [("g2", 2), ("g4", 4), ("g2_jitter", 2)])
def test_dist_relocate_and_grow_match_jax(world, name, g):
    case = world["mcmc"][name]
    (rp, rchg, rstats), (gp, galive, gchg, gn) = _jax_mcmc(case, g)
    res = [r[f"mcmc_{name}"] for r in world["results"]]
    cat = lambda i, k=None: (np.concatenate([res[r][i][k] for r in range(g)])
                             if k else np.concatenate([res[r][i]
                                                       for r in range(g)]))
    assert sum(res[r][2]["num_relocated"] for r in range(g)) == int(
        rstats["num_relocated"]) > 0
    assert sum(res[r][2]["num_dead"] for r in range(g)) == int(rstats["num_dead"])
    assert sum(res[r][6] for r in range(g)) == int(gn) > 0
    np.testing.assert_array_equal(cat(1), rchg)
    np.testing.assert_array_equal(cat(4), galive)
    np.testing.assert_array_equal(cat(5), gchg)
    edges = 0
    for got_i, ref, chg in ((0, rp, rchg), (3, gp, gchg)):
        got = {k: cat(got_i, k) for k in NAMES}
        diff = _differing_targets(got, ref, chg)
        edges += len(diff)
        keep = np.ones(chg.shape[0], bool)
        keep[diff] = False
        exact = case["cfg"]["exact_relocation"]
        for k in ("sh", "quats") + (("means",) if exact else ()):
            np.testing.assert_array_equal(got[k][keep], ref[k][keep],
                                          err_msg=k)
        for k in ("opacity_logits", "log_scales") + (() if exact
                                                     else ("means",)):
            np.testing.assert_allclose(got[k][keep], ref[k][keep], rtol=2e-5,
                                       atol=1e-6, err_msg=k)
    assert edges <= 3, edges


@pytest.mark.parametrize("env,init,world,rank", [
    ({"TPUGS_DISTRIBUTED": "1", "TPUGS_COORDINATOR": "host0:8476",
      "TPUGS_NUM_PROCESSES": "8", "TPUGS_PROCESS_ID": "5"},
     "tcp://host0:8476", 8, 5),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3"}, "env://", 4, 3),
    ({}, None, None, None),
])
def test_maybe_init_distributed_reads_the_launcher(monkeypatch, env, init,
                                                   world, rank):
    """tpugs' TPUGS_* variables, else torchrun's, else nothing; gloo on
    the CPU, a timeout always."""
    import torch.distributed as dist

    from tpugs_torch.parallel import distributed as D

    for k in ("TPUGS_DISTRIBUTED", "TPUGS_COORDINATOR",
              "TPUGS_NUM_PROCESSES", "TPUGS_PROCESS_ID", "RANK",
              "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    assert D.maybe_init_distributed("cpu", log=lambda *_: None) == bool(init)
    if init is None:
        assert not calls
        return
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == init
    assert (kw["world_size"], kw["rank"]) == (world, rank)
    assert kw["timeout"].total_seconds() == D.TIMEOUT_S

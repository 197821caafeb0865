"""The correctness chain of tpugs_torch against tpugs: the dense oracle
(ops/rasterize_ref.py), the scan compositor with its analytic backward
(ops/rasterize_tiled.py::CompositeScan), render(compositor="scan"),
render_state, and the tile-sharded scan route on gloo ranks; then the
chain inside the port, dense -> scan -> kernel route.

The same seeded numpy inputs go to both packages. Tolerances:
- forward colour and final_T atol 1e-5 against tpugs (the dense oracle's
  log1p / exp / cumsum and the scan's exp differ by ulps between XLA and
  torch), n_contrib equal;
- gradients against tpugs: rtol 1e-4, atol 2e-5 max|g| (the summation
  order of the scatter-adds and of the pixel sums differs);
- along the chain: dense -> scan colour atol 2e-5 and gradients atol
  3e-4 max|g| (tests/test_rasterize_tiled.py's bounds: the dense oracle
  takes transmittance from a log-space cumsum); scan -> kernel colour atol
  1e-5, gradients as against tpugs;
- the tile-sharded route: tests/test_torch_parallel.py's (colour 5e-7,
  gradients rtol 2e-5 / atol 1e-8, one step's params atol 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parallel import CFG as PAR_CFG
from tests.test_parallel import _tile_shard_forward, _tile_shard_grads
from tests.test_torch_parallel import ULP2, _jax_one_step, _jmesh, _scene
from tests.torch_dist import run_world
from tests.torch_parity import (assert_grads_close, jax_projection, np_,
                                random_projection, render_grads_both,
                                torch_projection)
from tpugs.core.gaussians import GaussianState as JaxState
from tpugs.ops import rasterize_ref as JREF
from tpugs.ops import rasterize_tiled as JT
from tpugs.ops.binning import bin_gaussians as jax_bin_gaussians
from tpugs.ops.render import render as jax_render
from tpugs.ops.render import render_state as jax_render_state
from tpugs_torch.core.gaussians import GaussianState, params_from_numpy
from tpugs_torch.ops import rasterize_ref as TREF
from tpugs_torch.ops import rasterize_tiled as TT
from tpugs_torch.ops.projection import project_gaussians
from tpugs_torch.ops.render import RasterConfig, render, render_state
from tpugs_torch.utils.synthetic import synthetic_params_numpy
from tpugs_torch.viewer.camera import orbit_trajectory

torch.set_num_threads(1)

ATOL = 1e-5
CHAIN_ATOL, CHAIN_GRAD_ATOL_REL = 2e-5, 3e-4
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")
W, H = 48, 32
INTR = np.float32([40.0, 40.0, W / 2.0, H / 2.0])
BG = np.float32([0.15, 0.25, 0.35])
CFG = RasterConfig(img_h=H, img_w=W, tile_h=16, tile_w=16,
                   pair_capacity=4096, max_hits_per_tile=128)
SCENES = {"mixed": (40, 5, (-2.0, 3.0)), "opaque": (50, 7, (3.0, 12.0))}


def _scene_params(n, seed, opac_logit_range):
    """tests/test_rasterize_tiled.py's make_scene, as numpy."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                            rng.uniform(2.0, 8.0, (n, 1))], axis=1)
    return {
        "means": means.astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.05, 0.3, (n, 3))).astype(np.float32),
        "opacity_logits": rng.uniform(*opac_logit_range, n).astype(np.float32),
        "sh": (rng.normal(size=(n, 3, 1)) * 0.7).astype(np.float32),
    }


def _cotangents(shape_hw, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_hw + (3,)).astype(np.float32),
            rng.normal(size=shape_hw).astype(np.float32))


# --- the dense oracle -----------------------------------------------------

PROJ_GRADS = ("means2d", "conic", "rgb", "opac")


def _dense_both(d, w, h, tile):
    """composite_dense in both packages on one projection, with the
    gradients of a seeded cotangent of colour and final_T in the projected
    attributes and the background."""
    c_col, c_t = _cotangents((h, w), 3)
    jp = jax_projection(d)

    def jloss(m, c, r, o, bg):
        col, t, nc = JREF.composite_dense(m, c, r, o, jp.visible, jp.depths,
                                          jp.radii, h, w, bg, tile, tile)
        return jnp.sum(col * c_col) + jnp.sum(t * c_t), (col, t, nc)

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True)(
        jp.means2d, jp.conic, jp.rgb, jp.opac, jnp.asarray(BG))
    tp = torch_projection(d)
    ins = [getattr(tp, k).clone().requires_grad_(True) for k in PROJ_GRADS]
    bg = torch.from_numpy(BG).requires_grad_(True)
    got = TREF.composite_dense(*ins, tp.visible, tp.depths, tp.radii, h, w,
                               bg, tile, tile)
    loss = ((got[0] * torch.from_numpy(c_col)).sum()
            + (got[1] * torch.from_numpy(c_t)).sum())
    tg = torch.autograd.grad(loss, ins + [bg])
    names = PROJ_GRADS + ("bg",)
    return (got, ref, dict(zip(names, map(np_, tg))),
            dict(zip(names, map(np.asarray, jg))))


@pytest.mark.parametrize("seed,tile,opaque", [(0, 16, False), (1, 16, True),
                                              (2, 32, False)])
def test_dense_oracle_matches_jax(seed, tile, opaque):
    w, h = 64, 48
    d = random_projection(120, w, h, seed)
    if opaque:
        d["opac"][:40] = 0.999  # alpha clamped at 0.99; pixels saturate
    got, ref, g, r = _dense_both(d, w, h, tile)
    np.testing.assert_allclose(np_(got[0]), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(np_(got[1]), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(np_(got[2]), np.asarray(ref[2]))
    assert np_(got[2]).max() > 1
    assert_grads_close(g, r)


# --- the scan compositor and its analytic backward ------------------------

def _scan_both(d, w, h, tile, max_hits=256):
    """composite_tiles in both packages on tpugs' binning of one
    projection, with the gradients of a seeded cotangent of colour and
    final_T (in tile layout)."""
    jcfg = JT.RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=8192, max_hits_per_tile=max_hits)
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                       pair_capacity=8192, max_hits_per_tile=max_hits)
    jp = jax_projection(d)
    b = jax_bin_gaussians(jp, w, h, tile, tile, 8192)
    c_col, c_t = _cotangents((cfg.num_tiles, cfg.pix), 4)

    def jloss(m, c, r, o, bg):
        out = JT.composite_tiles(jcfg, b.tile_start, b.tile_stop,
                                 b.pair_gauss, m, c, r, o, bg)
        return jnp.sum(out[0] * c_col) + jnp.sum(out[1] * c_t), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True)(
        jp.means2d, jp.conic, jp.rgb, jp.opac, jnp.asarray(BG))
    tp = torch_projection(d)
    ins = [getattr(tp, k).clone().requires_grad_(True) for k in PROJ_GRADS]
    bg = torch.from_numpy(BG).requires_grad_(True)
    seg = [torch.from_numpy(np.array(x)) for x in
           (b.tile_start, b.tile_stop, b.pair_gauss)]
    got = TT.composite_tiles(cfg, *seg, *ins, bg)
    loss = ((got[0] * torch.from_numpy(c_col)).sum()
            + (got[1] * torch.from_numpy(c_t)).sum())
    tg = torch.autograd.grad(loss, ins + [bg])
    names = PROJ_GRADS + ("bg",)
    return (got, ref, dict(zip(names, map(np_, tg))),
            dict(zip(names, map(np.asarray, jg))))


@pytest.mark.parametrize("case", ["mixed", "saturated", "tile32"])
def test_scan_compositor_vjp_matches_jax(case):
    """Forward and the VJP of colour and final_T, with alpha at the 0.99
    clamp (saturated: no opacity or position gradient there, and the
    transmittance gate cuts pixels short) and invisible gaussians."""
    w, h = 64, 48
    d = random_projection(150, w, h, {"mixed": 0, "saturated": 1,
                                      "tile32": 2}[case])
    if case == "saturated":
        d["opac"][:60] = 0.999
    tile = 32 if case == "tile32" else 16
    got, ref, g, r = _scan_both(d, w, h, tile)
    np.testing.assert_allclose(np_(got[0]), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(np_(got[1]), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_array_equal(np_(got[2]), np.asarray(ref[2]))
    if case == "saturated":
        assert (np_(got[1]) < 1.0 / 255.0).sum() > 50
    assert_grads_close(g, r)
    invisible = ~d["visible"]
    assert invisible.any()
    for k in PROJ_GRADS:
        assert not np.any(g[k][invisible]), k


def test_scan_backward_starts_at_the_longest_segment():
    """max_hits far past the longest segment walks the same entries: the
    port stops at the longest segment, tpugs scans all max_hits."""
    d = random_projection(100, 64, 48, 5)
    got, ref, g, r = _scan_both(d, 64, 48, 16, max_hits=1024)
    np.testing.assert_allclose(np_(got[0]), np.asarray(ref[0]), atol=ATOL)
    assert_grads_close(g, r)


# --- render(compositor="scan") and render_state ---------------------------

def _model(w, h, seed, n=300):
    p = synthetic_params_numpy(n, seed=seed)
    cam = orbit_trajectory(p["means"], 4, w, h)[seed % 4]
    return p, cam.world_to_camera().astype(np.float32), cam.intrinsics_array()


@pytest.mark.parametrize("presort", ["exact", False, "qkey", "fast"])
def test_render_scan_matches_jax(presort):
    """render(compositor="scan") against tpugs' scan branch with the probe:
    image, flags and every gradient; "qkey" takes the exact 2-key sort
    there, as in tpugs."""
    w, h = 64, 48
    p, vm, intr = _model(w, h, 1)
    alive = np.ones(300, bool)
    alive[::13] = False
    out, jo, got, ref = render_grads_both(p, alive, vm, intr, w, h, 16,
                                          presort, max_hits=256,
                                          compositor="scan")
    np.testing.assert_allclose(np_(out.color), np.asarray(jo.color), atol=ATOL)
    np.testing.assert_allclose(np_(out.final_T), np.asarray(jo.final_T),
                               atol=ATOL)
    np.testing.assert_array_equal(np_(out.n_contrib), np.asarray(jo.n_contrib))
    for f in ("num_pairs", "pair_overflow", "max_tile_hits", "hit_overflow"):
        assert int(getattr(out, f)) == int(getattr(jo, f)), f
    assert_grads_close(got, ref)
    assert np.abs(got["probe"]).max() > 0


def _busy_params(n=300):
    """tests/test_overflow.py's busy scene: every gaussian on one spot, so
    one tile's segment holds about n entries."""
    p = synthetic_params_numpy(n, seed=0, sh_coeffs=1)
    p["means"] = (np.float32([[0.0, 0.0, 5.0]]) + p["means"] * 0.001
                  ).astype(np.float32)
    return p


def test_render_scan_hit_truncation_matches_jax_and_kernel():
    """Past max_hits the scan and the kernel route composite the same
    front-most entries of the busy tile, as tpugs' scan."""
    p = _busy_params()
    n, w, h = 300, 64, 48
    intr = np.float32([w / 2.0, w / 2.0, w / 2.0, h / 2.0])
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                       pair_capacity=1 << 13, max_hits_per_tile=64)
    ref = jax_render(*[jnp.asarray(p[k]) for k in NAMES], jnp.ones(n, bool),
                     jnp.eye(4), jnp.asarray(intr),
                     JT.RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                                     pair_capacity=1 << 13,
                                     max_hits_per_tile=64),
                     0, jnp.zeros(3), compositor="scan")
    tp = params_from_numpy(p, "cpu")
    args = ([tp[k] for k in NAMES] + [torch.ones(n, dtype=torch.bool),
                                      torch.eye(4), torch.from_numpy(intr),
                                      cfg, 0, torch.zeros(3)])
    with torch.no_grad():
        scan = render(*args, compositor="scan")
        kern = render(*args, compositor="kernel", need_grads=False)
    assert bool(ref.hit_overflow) and bool(scan.hit_overflow)
    assert int(scan.max_tile_hits) == int(ref.max_tile_hits) > 64
    np.testing.assert_allclose(np_(scan.color), np.asarray(ref.color), atol=ATOL)
    np.testing.assert_allclose(np_(kern.color), np_(scan.color), atol=ATOL)


def test_scan_culled_gaussian_gets_no_gradient():
    p = _scene_params(10, 8, (-2.0, 3.0))
    p["means"][0] = [0.0, 0.0, -5.0]  # behind the camera
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    out = render(*[tp[k] for k in NAMES], torch.ones(10, dtype=torch.bool),
                 torch.eye(4), torch.from_numpy(INTR), CFG, 0,
                 torch.from_numpy(BG), compositor="scan")
    grads = torch.autograd.grad(out.color.sum(), [tp[k] for k in NAMES])
    for k, g in zip(NAMES, grads):
        assert not torch.any(g[0]), k
        assert torch.any(g[1:]), k


def test_render_state_matches_render_and_jax():
    w, h = 64, 48
    p, vm, intr = _model(w, h, 2, n=200)
    state = GaussianState.create(**p, capacity=256, device="cpu")
    jstate = JaxState(**{k: jnp.asarray(np_(getattr(state, k)))
                         for k in NAMES + ("alive",)})
    cfg = RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                       pair_capacity=8192, max_hits_per_tile=256)
    jcfg = JT.RasterConfig(img_h=h, img_w=w, tile_h=16, tile_w=16,
                           pair_capacity=8192, max_hits_per_tile=256)
    with torch.no_grad():
        got = render_state(state, torch.from_numpy(vm), torch.from_numpy(intr),
                           cfg, 3, torch.from_numpy(BG), need_grads=False)
        direct = render(state.means, state.quats, state.log_scales,
                        state.opacity_logits, state.sh, state.alive,
                        torch.from_numpy(vm), torch.from_numpy(intr), cfg, 3,
                        torch.from_numpy(BG), need_grads=False)
    ref = jax_render_state(jstate, jnp.asarray(vm), jnp.asarray(intr), jcfg,
                           3, jnp.asarray(BG), compositor="pallas",
                           need_grads=False)
    assert torch.equal(got.color, direct.color)
    assert torch.equal(got.n_contrib, direct.n_contrib)
    np.testing.assert_allclose(np_(got.color), np.asarray(ref.color), atol=ATOL)
    assert int(got.num_pairs) == int(ref.num_pairs) > 0


def test_render_refuses_an_unknown_compositor():
    p = _scene_params(10, 8, (-2.0, 3.0))
    tp = params_from_numpy(p, "cpu")
    with pytest.raises(ValueError, match="pallas"):
        render(*[tp[k] for k in NAMES], torch.ones(10, dtype=torch.bool),
               torch.eye(4), torch.from_numpy(INTR), CFG, 0, torch.zeros(3),
               compositor="pallas")


# --- the chain inside the port: dense -> scan -> kernel route -------------

def _port_grads(p, fn):
    """(outputs, gradients) of a seeded L2 loss of fn's colour in every
    parameter."""
    target = torch.from_numpy(
        np.random.default_rng(6).uniform(0, 1, (H, W, 3)).astype(np.float32))
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    out = fn(tp)
    loss = ((out[0] - target) ** 2).mean() + out[1].sum() * 1e-3
    grads = torch.autograd.grad(loss, [tp[k] for k in NAMES])
    return [np_(x) for x in out], dict(zip(NAMES, map(np_, grads)))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_chain_dense_scan_kernel(scene):
    """One scene, its pixels and gradients three ways: autograd through the
    dense oracle, the scan's analytic backward, the kernel route's."""
    p = _scene_params(*SCENES[scene])
    n = p["means"].shape[0]
    alive = torch.ones(n, dtype=torch.bool)
    view = (torch.eye(4), torch.from_numpy(INTR))
    bg = torch.from_numpy(BG)

    def dense(tp):
        proj = project_gaussians(*[tp[k] for k in NAMES], alive, *view, W, H,
                                 0)
        return TREF.render_reference(proj, H, W, bg)

    def routed(compositor):
        def fn(tp):
            o = render(*[tp[k] for k in NAMES], alive, *view, CFG, 0, bg,
                       compositor=compositor)
            assert not bool(o.pair_overflow) and not bool(o.hit_overflow)
            return o.color, o.final_T, o.n_contrib
        return fn

    (dc, dt, dn), dg = _port_grads(p, dense)
    (sc, st, sn), sg = _port_grads(p, routed("scan"))
    (kc, kt, kn), kg = _port_grads(p, routed("kernel"))
    np.testing.assert_allclose(sc, dc, atol=CHAIN_ATOL)
    np.testing.assert_allclose(st, dt, atol=CHAIN_ATOL)
    np.testing.assert_array_equal(sn, dn)
    assert_grads_close(sg, dg, rtol=0.0, atol_rel=CHAIN_GRAD_ATOL_REL)
    np.testing.assert_allclose(kc, sc, atol=ATOL)
    np.testing.assert_allclose(kt, st, atol=ATOL)
    np.testing.assert_array_equal(kn, sn)
    assert_grads_close(kg, sg)
    assert dn.max() > 1


# --- the tile-sharded scan route, on gloo ranks ---------------------------

@pytest.fixture(scope="module")
def scan_world(tmp_path_factory):
    params, alive, images, viewmats, intr = _scene()
    cfg = dict(img_h=PAR_CFG.img_h, img_w=PAR_CFG.img_w, tile_h=16,
               tile_w=16, pair_capacity=PAR_CFG.pair_capacity,
               max_hits_per_tile=PAR_CFG.max_hits_per_tile)
    results = run_world(4, "tests.torch_dist_cases:scan_world",
                        tmp_path_factory.mktemp("scan"), params=params,
                        alive=alive, images=images, viewmats=viewmats,
                        intr=intr, cfg=cfg)
    return dict(results=results, params=params, alive=alive, images=images,
                viewmats=viewmats, intr=intr)


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def test_tile_shard_scan_forward_matches_jax(scan_world):
    w = scan_world
    ref, _ = _tile_shard_forward(_jmesh(2, 2), _jax_params(w["params"]),
                                 jnp.asarray(w["alive"]),
                                 jnp.asarray(w["viewmats"][0]),
                                 jnp.asarray(w["intr"][0]), compositor="scan")
    colors = [r["forward"][0] for r in w["results"]]
    for c in colors[1:]:
        np.testing.assert_array_equal(c, colors[0])
    assert not any(r["forward"][1] or r["forward"][2] for r in w["results"])
    np.testing.assert_allclose(colors[0], np.asarray(ref), atol=ULP2, rtol=0)
    assert colors[0].max() > 0.1


def test_tile_shard_scan_gradients_match_jax(scan_world):
    w = scan_world
    ref_grads, ref_loss = _tile_shard_grads(
        _jmesh(2, 2), _jax_params(w["params"]), jnp.asarray(w["alive"]),
        jnp.asarray(w["images"][:2]), jnp.asarray(w["viewmats"][:2]),
        jnp.asarray(w["intr"][:2]), compositor="scan")
    res = w["results"]
    got = {k: np.concatenate([res[r]["grads"][0][k] for r in (0, 1)])
           for k in NAMES}
    np.testing.assert_allclose(res[0]["grads"][1], float(ref_loss), rtol=1e-5)
    for k in NAMES:
        np.testing.assert_allclose(got[k], np.asarray(ref_grads[k]),
                                   rtol=2e-5, atol=1e-8, err_msg=k)


def test_tile_shard_scan_train_step_matches_jax(scan_world):
    w = scan_world
    ref, ref_loss = _jax_one_step("tile_step", w, 2, 2, 2)
    res = w["results"]
    got = {k: np.concatenate([res[r]["tile_step"][0][k] for r in (0, 1)])
           for k in NAMES}
    for r in res:
        np.testing.assert_allclose(r["tile_step"][1], ref_loss, rtol=1e-5)
    for k in NAMES:
        np.testing.assert_allclose(got[k], ref[k], atol=2e-6, err_msg=k)


def test_dist_train_step_scan_matches_kernel():
    """make_dist_train_step(compositor="scan") on a 1x1 mesh (no process
    group) against its kernel route: the loss, Adam's first moment (the
    gradient) and ADC's accumulated screen-space gradient norms."""
    from tpugs_torch.optim.adam import adam_init
    from tpugs_torch.optim.densify_adc import adc_init
    from tpugs_torch.parallel.dist_train import make_dist_train_step
    from tpugs_torch.parallel.mesh import make_mesh
    from tpugs_torch.train.trainer import TrainConfig, TrainState, initial_key

    params, alive, images, viewmats, intr = _scene()
    params = {k: np.array(v) for k, v in params.items()}  # writable copies
    raster = RasterConfig(img_h=PAR_CFG.img_h, img_w=PAR_CFG.img_w,
                          tile_h=16, tile_w=16,
                          pair_capacity=PAR_CFG.pair_capacity,
                          max_hits_per_tile=PAR_CFG.max_hits_per_tile)
    mesh = make_mesh((1, 1), device="cpu")
    out = {}
    for compositor in ("kernel", "scan"):
        p = params_from_numpy(params, "cpu")
        state = TrainState(params=p, alive=torch.from_numpy(alive),
                           adam=adam_init(p), adc=adc_init(alive.shape[0], "cpu"),
                           key=initial_key(0))
        step = make_dist_train_step(TrainConfig(), raster, mesh, 2.0,
                                    compositor=compositor)
        new, stats = step(state, torch.from_numpy(images[0]),
                          torch.from_numpy(viewmats[0]),
                          torch.from_numpy(intr[0]), torch.zeros(()), 1)
        out[compositor] = (new, float(stats.loss))
    (k_state, k_loss), (s_state, s_loss) = out["kernel"], out["scan"]
    np.testing.assert_allclose(s_loss, k_loss, rtol=1e-6)
    assert_grads_close({k: np_(v) for k, v in s_state.adam.m.items()},
                        {k: np_(v) for k, v in k_state.adam.m.items()})
    assert_grads_close({"adc": np_(s_state.adc.grad_accum)},
                       {"adc": np_(k_state.adc.grad_accum)})
    assert float(k_state.adc.grad_accum.max()) > 0

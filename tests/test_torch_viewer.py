"""tpugs_torch's viewer path against tpugs' on the same inputs: the frame
cache and the cached frame (ops/render_cached.py, with tpugs' Pallas
kernels in interpret mode), the re-anchor policy and overflow growth of
OfflineRenderer.render_interactive, the orbit camera's moves, the web
viewer's requests (in process and over HTTP) and the viewer CLI."""
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_parity import np_
from tpugs.ops.render import RasterConfig as JaxConfig
from tpugs.ops.render import render as jax_render
from tpugs.ops.render_cached import build_frame_cache as jax_build
from tpugs.ops.render_cached import render_cached as jax_cached
from tpugs.viewer.camera import OrbitCamera as JaxOrbit
from tpugs.viewer.offline import OfflineRenderer as JaxRenderer
from tpugs.viewer.server import ViewerServer as JaxServer
from tpugs_torch.ops import pack
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.ops.render_cached import build_frame_cache, render_cached
from tpugs_torch.viewer.camera import OrbitCamera
from tpugs_torch.viewer.offline import OfflineRenderer
from tpugs_torch.viewer.server import ViewerServer

torch.set_num_threads(1)

W, H = 64, 48
INTR = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
BG = np.array([0.2, 0.3, 0.4], np.float32)
TILE, CAP, HITS = 16, 4096, 256
ATOL = 1e-5  # the qkey render's tolerance against tpugs (test_torch_render)
NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


def make_params(n=120, seed=0, opac=(-1.0, 5.0)):
    """tests/test_render_cached.py's scene, as numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        means=np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                              rng.uniform(2, 8, (n, 1))], 1).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)),
        opacity_logits=rng.uniform(*opac, n).astype(np.float32),
        sh=(rng.normal(size=(n, 3, 1)).astype(np.float32) * np.float32(0.5)),
    )


def rot_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return m


def _cfg():
    return RasterConfig(img_h=H, img_w=W, tile_h=TILE, tile_w=TILE,
                        pair_capacity=CAP, max_hits_per_tile=HITS)


def _jcfg():
    return JaxConfig(img_h=H, img_w=W, tile_h=TILE, tile_w=TILE,
                     pair_capacity=CAP, max_hits_per_tile=HITS)


def _alive(p, alive):
    return np.ones(p["means"].shape[0], bool) if alive is None else alive


def port_cache(p, vm, alive=None):
    t = {k: torch.from_numpy(p[k]) for k in NAMES}
    return build_frame_cache(*[t[k] for k in NAMES],
                             torch.from_numpy(_alive(p, alive)),
                             torch.from_numpy(vm), torch.from_numpy(INTR),
                             _cfg(), 0)


def port_exact(p, vm, alive=None):
    t = {k: torch.from_numpy(p[k]) for k in NAMES}
    return render(*[t[k] for k in NAMES], torch.from_numpy(_alive(p, alive)),
                  torch.from_numpy(vm), torch.from_numpy(INTR), _cfg(), 0,
                  torch.from_numpy(BG), presort="qkey", need_grads=False)


def port_frame(cache, vm):
    return render_cached(cache, torch.from_numpy(vm), torch.from_numpy(INTR),
                         _cfg(), torch.from_numpy(BG))


def jax_cache(p, vm, alive=None):
    return jax_build(*[jnp.asarray(p[k]) for k in NAMES],
                     jnp.asarray(_alive(p, alive)), jnp.asarray(vm),
                     jnp.asarray(INTR), _jcfg(), 0)


def jax_exact(p, vm):
    return jax_render(*[jnp.asarray(p[k]) for k in NAMES],
                      jnp.ones(p["means"].shape[0], bool), jnp.asarray(vm),
                      jnp.asarray(INTR), _jcfg(), 0, jnp.asarray(BG),
                      compositor="pallas", presort="qkey", need_grads=False)


def psnr(a, b):
    mse = float(np.mean((np_(a) - np_(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("seed", [2, 3])
def test_frame_cache_matches_jax(seed):
    """Segments and the honesty fields equal; the static table within rtol
    1e-6 of each row's largest magnitude inside the segments, and zero in
    their gaps (the columns past the last tile's padded end are the
    kernel's unwritten tail). The covariance components are sums of
    products of either sign, so an entry near zero carries its terms'
    exp() ulps between XLA and torch. The quantized key leaves same-bin
    order open, so each segment's columns are compared as a set, ordered by
    their world means (the same inputs on both sides)."""
    p, vm = make_params(120, seed), rot_y(0.02 * seed)
    got, ref = port_cache(p, vm), jax_cache(p, vm)
    for f in ("astart", "astop", "num_pairs", "pair_overflow",
              "max_tile_hits"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np_(getattr(ref, f)), err_msg=f)
    astart, astop = np_(got.astart), np_(got.astop)
    g, r = np_(got.static_attr), np_(ref.static_attr)
    end = int(astart[-1]) + -(-int(astop[-1] - astart[-1]) // pack.LANE_ALIGN) \
        * pack.LANE_ALIGN
    scale = np.abs(r[:, :end]).max(1, keepdims=True)
    for a0, a1 in zip(astart, astop):
        seg_g, seg_r = g[:, a0:a1], r[:, a0:a1]
        og = np.lexsort(seg_g[2::-1])
        orr = np.lexsort(seg_r[2::-1])
        assert (np.abs(seg_g[:, og] - seg_r[:, orr]) <= 1e-6 * scale).all()
    gaps = np.ones(end, bool)
    for a0, a1 in zip(astart, astop):
        gaps[a0:a1] = False
    assert not g[:, :end][:, gaps].any() and not r[:, :end][:, gaps].any()
    assert int(got.num_pairs) > 0 and (astop > astart).sum() > 1


@pytest.mark.parametrize("theta", [0.0, 0.004])
def test_cached_frame_matches_jax(theta):
    """At zero and a small delta (0.23 deg) from the anchor, within the
    qkey render's tolerance against tpugs."""
    p, anchor = make_params(120, 1), np.eye(4, dtype=np.float32)
    vm = rot_y(theta)
    color, final_t = port_frame(port_cache(p, anchor), vm)
    rc, rt = jax_cached(jax_cache(p, anchor), jnp.asarray(vm),
                        jnp.asarray(INTR), _jcfg(), jnp.asarray(BG))
    np.testing.assert_allclose(np_(color), np_(rc), atol=ATOL)
    np.testing.assert_allclose(np_(final_t), np_(rt), atol=ATOL)
    assert np_(final_t).min() < 0.5  # the scene covers the frame


@pytest.mark.parametrize("seed,alive_n", [(1, None), (4, 60), (5, None)])
def test_zero_delta_cached_frame_is_the_exact_render(seed, alive_n):
    """The port's cached frame at its anchor is the port's
    render(presort="qkey", need_grads=False), bit for bit, with dead slots
    dead; the honesty fields are the render's."""
    n = 120
    p = make_params(n, seed)
    alive = None if alive_n is None else np.arange(n) < alive_n
    anchor = rot_y(0.01 * seed)
    cache = port_cache(p, anchor, alive)
    exact = port_exact(p, anchor, alive)
    color, final_t = port_frame(cache, anchor)
    np.testing.assert_array_equal(np_(color), np_(exact.color))
    np.testing.assert_array_equal(np_(final_t), np_(exact.final_T))
    for f in ("num_pairs", "pair_overflow", "max_tile_hits"):
        assert int(getattr(cache, f)) == int(getattr(exact, f)), f
    if alive is not None:  # the dead half does change the image
        assert not np.array_equal(np_(color), np_(port_exact(p, anchor).color))


def test_drift_grows_with_the_angle():
    """tests/test_render_cached.py's drift case on the port, held to tpugs'
    PSNRs: close at 0.3 deg, worse at 8.6 deg, as tpugs' are."""
    p, anchor = make_params(200, 3, opac=(1.0, 5.0)), np.eye(4, dtype=np.float32)
    cache, jcache = port_cache(p, anchor), jax_cache(p, anchor)
    got, ref = {}, {}
    for theta in (0.005, 0.15):
        vm = rot_y(theta)
        exact = port_exact(p, vm)
        got[theta] = psnr(port_frame(cache, vm)[0], exact.color)
        rc, _ = jax_cached(jcache, jnp.asarray(vm), jnp.asarray(INTR),
                           _jcfg(), jnp.asarray(BG))
        ref[theta] = psnr(rc, jax_exact(p, vm).color)
    assert got[0.005] > 34.0 and got[0.005] > got[0.15], got
    for theta in got:
        assert abs(got[theta] - ref[theta]) < 0.5, (got, ref)


def _policy_moves():
    """tests/test_render_cached.py's sequence: (viewmat, intrinsics)."""
    return [(np.eye(4, dtype=np.float32), INTR),
            (rot_y(0.001), INTR),  # 0.06 deg: the same anchor
            (rot_y(0.2), INTR),  # 11 deg: a new one
            (rot_y(0.2), INTR * np.float32(1.5))]  # the FOV moved: new


def test_reanchor_decisions_match_jax():
    p = make_params(120, 5)
    kw = dict(tile=TILE, pair_capacity=CAP, max_hits=HITS)
    port = OfflineRenderer(p, device="cpu", **kw)
    ref = JaxRenderer(p, **kw)
    decisions = {"port": [], "jax": []}
    for vm, intr in _policy_moves():
        for name, r in (("port", port), ("jax", ref)):
            before = r._icache
            r.render_interactive(H, W, vm, intr, (0.0, 0.0, 0.0))
            decisions[name].append((r._icache is before, r._icache["age"]))
    assert decisions["port"] == decisions["jax"]
    assert decisions["port"] == [(False, 1), (True, 2), (False, 1), (False, 1)]
    assert [s.path for s in port.frame_stats] == [
        "anchor", "cached", "anchor", "anchor"]
    assert set(port._icache) >= {"key", "cache", "vm", "intr", "age"}


@pytest.mark.parametrize("reanchor_frames", [0, 2])
def test_frame_limit_and_shift_reanchor_as_jax(reanchor_frames):
    """A frame limit, and a pan past reanchor_shift_frac of the distance,
    re-anchor on both sides alike."""
    p = make_params(120, 6)
    kw = dict(tile=TILE, pair_capacity=CAP, max_hits=HITS,
              reanchor_frames=reanchor_frames)
    moves = [np.eye(4, dtype=np.float32)] * 3
    shifted = np.eye(4, dtype=np.float32)
    shifted[0, 3] = 0.5  # the camera center moves 0.5 at distance 0
    moves.append(shifted)
    out = {}
    for name, r in (("port", OfflineRenderer(p, device="cpu", **kw)),
                    ("jax", JaxRenderer(p, **kw))):
        ages = []
        for vm in moves:
            r.render_interactive(H, W, vm, INTR, (0.0, 0.0, 0.0))
            ages.append(r._icache["age"])
        out[name] = ages
    assert out["port"] == out["jax"]


def test_interactive_overflow_grows_as_jax():
    p = make_params(120, 6)
    kw = dict(tile=TILE, pair_capacity=64, max_hits=16, log=lambda m: None)
    port = OfflineRenderer(p, device="cpu", **kw)
    ref = JaxRenderer(p, **kw)
    port.render_interactive(H, W, np.eye(4, dtype=np.float32), INTR,
                            (0.0, 0.0, 0.0))
    ref.render_interactive(H, W, np.eye(4, dtype=np.float32), INTR,
                           (0.0, 0.0, 0.0))
    assert (port.pair_capacity, port.max_hits) == (ref.pair_capacity,
                                                   ref.max_hits)
    assert port.pair_capacity > 64 and port.max_hits > 16
    assert not bool(port._icache["cache"].pair_overflow)


def test_orbit_camera_moves_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3))
    cams = (OrbitCamera.from_points(pts, 50.0), JaxOrbit.from_points(pts, 50.0))
    moves = [("rotate", 0.3, -0.2), ("pan", 0.1, 0.05), ("zoom", 0.8),
             ("rotate", -1.1, 2.0), ("pan", -0.4, 0.2), ("zoom", 1e-9),
             ("zoom", 3.0), ("rotate", 0.05, -3.0)]
    for name, *args in moves:
        for c in cams:
            getattr(c, name)(*args)
        a, b = cams
        assert a.version() == b.version()
        np.testing.assert_allclose(a.target, b.target, rtol=0, atol=1e-12)
        for f in ("radius", "azimuth", "elevation"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12, f
        ia, ib = a.build_camera(96, 64), b.build_camera(96, 64)
        np.testing.assert_allclose(ia.R, ib.R, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ia.t, ib.t, rtol=0, atol=1e-12)
    assert cams[0].version() == len(moves)


def _server_params(n=64, seed=0):
    """tests/test_viewer_server.py's model (SH degree 2)."""
    rng = np.random.default_rng(seed)
    return {
        "means": rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        "quats": rng.normal(0, 1, (n, 4)).astype(np.float32),
        "log_scales": rng.uniform(-2.5, -1.5, (n, 3)).astype(np.float32),
        "opacity_logits": rng.normal(1.0, 0.5, n).astype(np.float32),
        "sh": rng.normal(0, 0.3, (n, 3, 9)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def servers():
    kw = dict(width=64, height=64, tile=16, pair_capacity=4096, max_hits=256)
    return (ViewerServer(_server_params(), device="cpu", **kw),
            JaxServer(_server_params(), **kw))


def _decode(jpg):
    return np.asarray(Image.open(io.BytesIO(jpg)))


# tests/test_viewer_server.py's requests, in its order.
REQUESTS = [{"sh": 2}, {"sh": 0}, {"sh": 9}, {"fov": 30}, {"fov": 110},
            {"fov": 1.0}, {"fov": 400.0}, {"mode": "rgb"}, {"mode": "depth"},
            {"mode": "heatmap"}, {"scale": 2}, {"scale": 2, "azimuth": 0.1},
            {"scale": 2, "azimuth": 0.102},
            {"scale": 2, "mode": "depth", "azimuth": 0.102},
            {"azimuth": 0.102}]


def test_server_requests_match_jax(servers):
    """Every request of tpugs' server tests: the same image sizes, within
    2/255 mean absolute difference of tpugs' JPEGs; the SH slider, the FOV
    and the drag frames change the image as there; drag frames take the
    cached path, release, depth and heatmap frames the exact one."""
    port, ref = servers
    port.renderer._icache = ref.renderer._icache = None
    assert port.renderer.max_sh_degree == ref.renderer.max_sh_degree == 2
    imgs = {}
    for i, req in enumerate(REQUESTS):
        got = _decode(port.render_jpeg(dict(req)))
        want = _decode(ref.render_jpeg(dict(req)))
        assert got.shape == want.shape, req
        diff = np.abs(got.astype(np.float64) - want).mean() / 255.0
        assert diff <= 2 / 255, (req, diff)
        imgs[i] = got
    assert imgs[0].shape == (64, 64, 3) and imgs[10].shape == (32, 32, 3)
    assert not np.array_equal(imgs[0], imgs[1])  # SH 0 vs 2
    np.testing.assert_array_equal(imgs[0], imgs[2])  # capped at 2
    assert not np.array_equal(imgs[3], imgs[4])  # FOV
    assert not np.array_equal(imgs[11], imgs[12])  # the drag delta
    paths = [s.path for s in port.renderer.frame_stats[-5:]]
    assert paths == ["anchor", "anchor", "cached", "exact", "exact"]
    assert port.renderer._icache["age"] == 2


def test_server_serializes_concurrent_renders(servers):
    """More handler threads than cores, with a short switch interval: the
    render lock keeps the shared renderer's anchor and frame log whole
    (every request logs one frame, each anchor's age counts the frames
    drawn on it)."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    port = servers[0]
    r = port.renderer
    r._icache = None
    n0 = len(r.frame_stats)
    reqs = [{"scale": 2, "azimuth": 0.0005 * i} for i in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=2 * (os.cpu_count() or 4)) as ex:
            jpgs = list(ex.map(port.render_jpeg, reqs, timeout=300))
    finally:
        sys.setswitchinterval(old)
    assert all(_decode(j).shape == (32, 32, 3) for j in jpgs)
    paths = [s.path for s in r.frame_stats[n0:]]
    assert len(paths) == len(reqs) and paths[0] == "anchor"
    runs = "".join("A" if x == "anchor" else "c" for x in paths).split("A")[1:]
    assert len(runs[-1]) + 1 == r._icache["age"]


def _http(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_server_over_http(servers):
    """One real round trip on a free port: the page, /info, a drag and a
    release frame, and the 404s; then the server shuts down."""
    port = servers[0]
    server = port.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        code, ctype, body = _http(base + "/")
        assert code == 200 and ctype == "text/html" and b"/render" in body
        code, _, body = _http(base + "/info")
        info = json.loads(body)
        assert code == 200 and info == {
            "radius": port.base_cam.radius, "num_gaussians": 64,
            "max_sh_degree": 2}
        for req, shape in (({"scale": 2, "azimuth": 0.3}, (32, 32, 3)),
                           ({"azimuth": 0.3, "mode": "heatmap"}, (64, 64, 3))):
            code, ctype, body = _http(base + "/render", json.dumps(req).encode())
            assert code == 200 and ctype == "image/jpeg"
            assert _decode(body).shape == shape
        assert _http(base + "/nothing")[0] == 404
        assert _http(base + "/nothing", b"{}")[0] == 404
        code, _, body = _http(base + "/render", b'{"mode": "x"}')
        assert code == 500 and b"unknown mode" in body
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_viewer_cli_builds_its_server(monkeypatch, tmp_path):
    from tpugs_torch.apps import viewer as viewer_app
    from tpugs_torch.io.ply import write_gaussian_ply_numpy
    from tpugs_torch.viewer import server as server_mod

    p = _server_params()
    ply = str(tmp_path / "m.ply")
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    served = []
    monkeypatch.setattr(server_mod.ViewerServer, "serve",
                        lambda self, host, port: served.append((self, host, port)))
    argv = ["-m", ply, "--port", "8123", "--width", "96", "--height", "64",
            "--tile", "16", "--sh-degree", "1", "--background", "0.1", "0.2",
            "0.3", "--on-overflow", "warn", "--device", "cpu"]
    assert viewer_app.main(argv) == 0
    (srv, host, port), = served
    assert (host, port) == ("127.0.0.1", 8123)
    assert (srv.width, srv.height, srv.background) == (96, 64, (0.1, 0.2, 0.3))
    r = srv.renderer
    assert (r.tile, r.sh_degree, r.on_overflow, r.device.type) == (
        16, 1, "warn", "cpu")
    assert _decode(srv.render_jpeg({"scale": 2})).shape == (32, 48, 3)

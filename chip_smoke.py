#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpugs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each under a watchdog that ends a hung run with a stack trace and
a nonzero exit:
  0. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  1. build: the one kernel library, with nvcc alone (tpugs_torch/cuda_lib);
  2. kernels against their plain PyTorch versions on a 20k-gaussian scene
     at 256x192, tiles of 16 and 32: expand and align-copy bit-identical,
     the forward compositor within the stated tolerances;
  3. the render CLI itself (tpugs_torch.apps.render.main), 3 frames at
     1920x1080 of a 1M-gaussian SH-degree-3 PLY, no overflow, every frame
     through all three kernels; then each kernel timed alone at that frame's
     shapes beside its bound, its plain version and a library call, and held
     against its plain version on the whole frame.
Prints a {"kernels": [...]} line, the nvidia-smi line and, only when every
phase passed, {"ok": true, "device": {...}} as the last line.
"""
from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ATOL = 1e-5  # compositor color and T: ulp-scale drift of summation order
MIN_MATCH = 0.999  # compositor n_contrib / k_last: share of equal pixels

CLI_N = 1_000_000
CLI_W, CLI_H = 1920, 1080
CLI_FRAMES = 3
CLI_PAIR_CAPACITY = 1 << 24  # the port sizes its pair arrays by the real count
CLI_MAX_HITS = 1 << 20

_T0 = time.perf_counter()


class Phase:
    """Prints one line with the phase's elapsed seconds; arms a watchdog
    that dumps every thread's stack and exits 1 after `budget` seconds."""

    def __init__(self, name: str, budget: float):
        self.name, self.budget = name, budget

    def __enter__(self):
        faulthandler.dump_traceback_later(self.budget, exit=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        faulthandler.cancel_dump_traceback_later()
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[phase {self.name}] {status} in {dt:.1f} s "
              f"(total {time.perf_counter() - _T0:.1f} s)", flush=True)
        return False


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build():
    from tpugs_torch import cuda_lib

    path = cuda_lib.build()
    cuda_lib.lib()
    regs = re.findall(r"Function properties for (\S+)|Used (\d+) registers",
                      cuda_lib.build_log)
    used = [int(r[1]) for r in regs if r[1]]
    spills = re.findall(r"(\d+) bytes spill stores", cuda_lib.build_log)
    print(f"built {os.path.relpath(path)} in "
          f"{cuda_lib.build_seconds if cuda_lib.build_seconds else 0:.1f} s; "
          f"registers per thread {used}, spill stores {spills}", flush=True)


def _scene(dev, n, w, h, seed, **kw):
    import torch

    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.utils.synthetic import (synthetic_intrinsics_numpy,
                                             synthetic_params)

    p = synthetic_params(n, seed=seed, device=dev, **kw)
    intr = torch.as_tensor(synthetic_intrinsics_numpy(w, h), device=dev)
    return project_gaussians(
        p["means"], p["quats"], p["log_scales"], p["opacity_logits"], p["sh"],
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.eye(4, device=dev), intr, w, h, 3)


def compare_compositor(got, ref):
    """(max abs err of color and T, share of equal n_contrib, of equal
    k_last); raises past the tolerances."""
    import torch

    (c, t, nc, kl), (c0, t0, nc0, kl0) = got, ref
    err = max(float((c - c0).abs().max()), float((t - t0).abs().max()))
    m_nc = float((nc == nc0).float().mean())
    m_kl = float((kl == kl0).float().mean())
    check(bool(torch.isfinite(c).all()) and bool(torch.isfinite(t).all()),
          "compositor output not finite")
    check(err <= ATOL, f"compositor color/T max abs err {err} > {ATOL}")
    check(m_nc >= MIN_MATCH and m_kl >= MIN_MATCH,
          f"compositor n_contrib/k_last match {m_nc}/{m_kl} < {MIN_MATCH}")
    return err, m_nc, m_kl


def phase_kernels(dev, errs):
    """Each kernel against its plain version, small scene, tiles 16 and 32."""
    import torch

    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops import composite_t, expand, pack
    from tpugs_torch.ops.rasterize_tiled import RasterConfig

    w, h = 256, 192
    proj = _scene(dev, 20_000, w, h, seed=0)
    for tile in (16, 32):
        full = B.expand_inputs(proj, w, h, tile, tile, 1 << 24).total
        for cap, qbits, presort in ((1 << 24, 0, False), (full // 2, 0, False),
                                    (1 << 24, 32, False), (1 << 24, 0, True)):
            pr = B.presort_by_depth(proj)[1] if presort else proj
            ex = B.expand_inputs(pr, w, h, tile, tile, cap, presort, qbits)
            args = (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile)
            k_out = expand.expand_pairs(*args)
            p_out = expand.expand_pairs_plain(*args)
            for a, b in zip(k_out, p_out):
                check(torch.equal(a, b), f"expand differs (tile {tile}, cap {cap})")
            bk, bp = (B.sort_pairs(*o, ex.num_tiles, proj.depths.shape[0],
                                   ex.total, cap, presort, ex.qbits)
                      for o in (k_out, p_out))
            for f in ("tile_start", "tile_stop"):
                check(torch.equal(getattr(bk, f), getattr(bp, f)),
                      f"binning {f} differs")
            if not qbits:  # the qkey sort is unstable: same-bin order free
                check(torch.equal(bk.pair_gauss, bp.pair_gauss),
                      "sorted pair_gauss differs")
        errs["expand"] = 0.0
        cfg = RasterConfig(img_h=h, img_w=w, tile_h=tile, tile_w=tile,
                           pair_capacity=1 << 24, max_hits_per_tile=1 << 20)
        b = B.bin_gaussians_expand_kernel(proj, w, h, tile, tile, cfg.pair_capacity)
        astart, astop, counts = pack.aligned_offsets(b.tile_start, b.tile_stop)
        pal = pack.aligned_length(astart, counts)
        attr_c = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                         proj.rgb, proj.opac, b.pair_gauss.shape[0])
        attr = pack.align_copy(attr_c, b.tile_start, astart, counts, pal)
        ref = pack.align_copy_plain(attr_c, b.tile_start, astart, counts, pal)
        check(torch.equal(attr, ref), f"align-copy differs (tile {tile})")
        errs["align_copy"] = 0.0
        got = composite_t.composite_forward(cfg, astart, astop, attr)
        ref = composite_t.composite_forward_plain(cfg, astart, astop, attr)
        err, m_nc, m_kl = compare_compositor(got, ref)
        errs["composite_fwd"] = max(errs.get("composite_fwd", 0.0), err)
        torch.cuda.synchronize()
        print(f"tile {tile}: {ex.total} pairs, expand + sort bit-identical "
              f"(also at capacity {full // 2}), align-copy bit-identical, "
              f"compositor max abs err {err:.3g}, n_contrib/k_last equal "
              f"{m_nc:.6f}/{m_kl:.6f}", flush=True)


def phase_cli(tmp, dev):
    """The render CLI at full width; returns the per-frame lines and launch
    counts of its run."""
    import numpy as np
    from PIL import Image

    from tpugs_torch.apps import render as render_app
    from tpugs_torch.io.ply import write_gaussian_ply_numpy
    from tpugs_torch.ops import composite_t, expand, pack
    from tpugs_torch.utils.synthetic import synthetic_params_numpy

    p = synthetic_params_numpy(CLI_N, seed=0, scale_range=(0.002, 0.015))
    ply = os.path.join(tmp, "scene_1m_sh3.ply")
    write_gaussian_ply_numpy(ply, p["means"], p["sh"], p["opacity_logits"],
                             p["log_scales"], p["quats"])
    frames = os.path.join(tmp, "frames")
    argv = ["-m", ply, "-o", frames, "--frames", str(CLI_FRAMES),
            "--width", str(CLI_W), "--height", str(CLI_H),
            "--pair-capacity", str(CLI_PAIR_CAPACITY),
            "--max-hits", str(CLI_MAX_HITS), "--on-overflow", "error",
            "--device", dev.type]
    wrappers = (expand.expand_pairs, pack.align_copy, composite_t.composite_forward)
    for fn in wrappers:
        fn.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = render_app.main(argv)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    check(rc == 0, f"render CLI returned {rc}")
    stats = re.findall(r"frame (\d+): \S+ pairs (\d+) max_tile_hits (\d+) "
                       r"ms ([\d.]+)", out.getvalue())
    check(len(stats) == CLI_FRAMES, f"CLI printed {len(stats)} frame lines")
    for i, pairs, hits, ms in stats:
        tag = "warm-up" if int(i) == 0 else "steady"
        print(f"cli frame {i} ({tag}): {pairs} pairs, busiest tile {hits}, "
              f"{float(ms):.3f} ms", flush=True)
    steady = [float(s[3]) for s in stats[1:]]
    print(f"cli 1920x1080 1M SH3: {np.mean(steady):.3f} ms/frame after "
          f"warm-up; launches {launches}", flush=True)
    for name, count in launches.items():
        check(count == CLI_FRAMES, f"{name} launched {count} times in "
              f"{CLI_FRAMES} frames (expected 1 per frame)")
    for i in range(CLI_FRAMES):
        img = np.asarray(Image.open(os.path.join(frames, f"frame_{i:04d}.png")))
        check(img.shape == (CLI_H, CLI_W, 3), f"frame {i} shape {img.shape}")
        check(img.max() > 0, f"frame {i} is black")
    return p, launches, stats


def phase_timing(dev, params, launches, errs):
    """Frame 0's kernel inputs, each kernel timed alone and held against its
    plain version on the whole frame."""
    import numpy as np
    import torch

    from tpugs_torch.core.gaussians import params_from_numpy
    from tpugs_torch.ops import binning as B
    from tpugs_torch.ops import composite_t, expand, pack
    from tpugs_torch.ops.projection import project_gaussians
    from tpugs_torch.ops.rasterize_tiled import T_THRESHOLD, RasterConfig
    from tpugs_torch.viewer.camera import orbit_trajectory

    tile = 32
    cfg = RasterConfig(img_h=CLI_H, img_w=CLI_W, tile_h=tile, tile_w=tile,
                       pair_capacity=CLI_PAIR_CAPACITY,
                       max_hits_per_tile=CLI_MAX_HITS)
    cam = orbit_trajectory(params["means"], CLI_FRAMES, CLI_W, CLI_H)[0]
    p = params_from_numpy(params, dev)
    n = p["means"].shape[0]
    proj = project_gaussians(
        p["means"], p["quats"], p["log_scales"], p["opacity_logits"], p["sh"],
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.as_tensor(cam.world_to_camera(), dtype=torch.float32, device=dev),
        torch.as_tensor(cam.intrinsics_array(), device=dev), CLI_W, CLI_H, 3)
    # The CLI's presort="fastest" takes the qkey sort at N = 1M.
    ex = B.expand_inputs(proj, CLI_W, CLI_H, tile, tile, cfg.pair_capacity,
                         quant_key_bits=32)
    args = (ex.itab, ex.ftab, ex.p_out, ex.num_tiles, ex.ntx, tile, tile)
    kern = expand.expand_pairs(*args)
    plain = expand.expand_pairs_plain(*args)
    check(all(torch.equal(a, b) for a, b in zip(kern, plain)),
          "expand differs from its plain version on the full frame")
    rows = []
    k_ms = cuda_ms(lambda: expand.expand_pairs(*args))
    pl_ms = cuda_ms(lambda: expand.expand_pairs_plain(*args), reps=3)
    k1_bytes = ex.itab.numel() * 4 + ex.ftab.numel() * 4 + ex.p_out * 12
    k1_ops = ex.p_out * 16  # index math, clamp, cull per slot
    rows.append(("expand", "tpugs_torch/csrc/expand.cu",
                 "tpugs/ops/pallas/expand.py:82", k_ms, pl_ms, k1_bytes,
                 k1_ops, None))

    b = B.sort_pairs(*kern, ex.num_tiles, n, ex.total, cfg.pair_capacity,
                     qbits=ex.qbits)
    b, _ = B.clamp_tile_segments(b, cfg.max_hits_per_tile)
    astart, astop, counts = pack.aligned_offsets(b.tile_start, b.tile_stop)
    pal = pack.aligned_length(astart, counts)
    attr_c = pack.pack_compact_attrs(b.pair_gauss, proj.means2d, proj.conic,
                                     proj.rgb, proj.opac, b.pair_gauss.shape[0])
    a2 = (attr_c, b.tile_start, astart, counts, pal)
    attr = pack.align_copy(*a2)
    check(torch.equal(attr, pack.align_copy_plain(*a2)),
          "align-copy differs from its plain version on the full frame")
    k_ms = cuda_ms(lambda: pack.align_copy(*a2))
    pl_ms = cuda_ms(lambda: pack.align_copy_plain(*a2), reps=3)
    # Library yardstick: one index_select of the same columns, gaps pointing
    # at an appended zero column.
    j = torch.arange(pal, device=dev)
    owner = torch.searchsorted(astart.long(), j, right=True) - 1
    k = j - astart.long()[owner]
    src = torch.where(k < counts.long()[owner], b.tile_start.long()[owner] + k,
                      torch.full_like(k, attr_c.shape[1]))
    attr_z = torch.cat([attr_c, torch.zeros_like(attr_c[:, :1])], 1)
    check(torch.equal(attr_z.index_select(1, src), attr), "index_select yardstick")
    lib_ms = cuda_ms(lambda: attr_z.index_select(1, src))
    entries = int(counts.sum())
    rows.append(("align_copy", "tpugs_torch/csrc/align_copy.cu",
                 "tpugs/ops/pallas/pack.py:100", k_ms, pl_ms,
                 entries * 64 + pal * 64, 0, lib_ms))

    got = composite_t.composite_forward(cfg, astart, astop, attr)
    k_ms = cuda_ms(lambda: composite_t.composite_forward(cfg, astart, astop, attr))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = composite_t.composite_forward_plain(cfg, astart, astop, attr)
    torch.cuda.synchronize()
    pl_ms = (time.perf_counter() - t0) * 1e3
    err, m_nc, m_kl = compare_compositor(got, ref)
    # 8 tiles from the seed, the busiest among them, also on their own.
    busiest = int(torch.argmax(counts))
    rng = np.random.default_rng(0)
    pick = [busiest] + [int(t) for t in rng.choice(cfg.num_tiles, 7, replace=False)]
    sel = torch.tensor(pick, device=dev)
    sub = composite_t.composite_forward_plain(cfg, astart, astop, attr, tiles=sel)
    err8, _, _ = compare_compositor(tuple(g[sel] for g in got), sub)
    errs["composite_fwd"] = max(errs.get("composite_fwd", 0.0), err, err8)
    # Work this frame needs: a pixel walks its tile's entries until T drops
    # below the threshold (then k_last + 1 of them), else all of them.
    _, final_t, n_contrib, k_last = got
    num = counts.long()[:, None].expand_as(k_last)
    walked = torch.where(final_t < T_THRESHOLD, k_last.long() + 1, num)
    pairs_eval = int(walked.sum())
    # 17 f32 operations per evaluated (pixel, entry), exp counted as one,
    # and 9 more per contribution.
    k3_ops = 17 * pairs_eval + 9 * int(n_contrib.sum())
    k3_bytes = entries * 36 + cfg.num_tiles * cfg.pix * 24
    rows.append(("composite_fwd", "tpugs_torch/csrc/composite_fwd.cu",
                 "tpugs/ops/pallas/composite_t.py:180", k_ms, pl_ms, k3_bytes,
                 k3_ops, None))
    print(f"full frame: {ex.total} pairs, {entries} composited entries, "
          f"{pal} aligned columns; expand and align-copy bit-identical to "
          f"their plain versions; compositor max abs err {err:.3g} "
          f"(n_contrib/k_last equal {m_nc:.6f}/{m_kl:.6f}), on 8 tiles incl. "
          f"the busiest ({int(counts[busiest])} entries) {err8:.3g}", flush=True)

    table = []
    for name, source, replaces, ms, plain_ms, nbytes, ops, lib_ms in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[{"expand": "expand_pairs",
                                  "align_copy": "align_copy",
                                  "composite_fwd": "composite_forward"}[name]],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        print(f"{name}: {ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({table[-1]['bound_by']}), plain {plain_ms:.2f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}", flush=True)
    return table


def main() -> int:
    with Phase("device", 90):
        card = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    with Phase("build", 240):
        phase_build()
    errs = {}
    with Phase("kernels", 300):
        phase_kernels(dev, errs)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("cli", 600):
            params, launches, _ = phase_cli(tmp, dev)
        with Phase("timing", 480):
            table = phase_timing(dev, params, launches, errs)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

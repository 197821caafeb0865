"""Offline viewer: render camera trajectories to image files, and the
frame-coherent interactive path of the web viewer (viewer/server.py), as in
tpugs/viewer/offline.py.

Three render modes: RGB, depth (1 - final_T opacity proxy with a turbo
colormap) and a contributor-count heatmap.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Iterable

import numpy as np
import torch
from PIL import Image

from tpugs_torch import cuda_lib
from tpugs_torch.core.camera import CameraInfo
from tpugs_torch.core.gaussians import params_from_numpy
from tpugs_torch.device import resolve_device
from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.ops.render_cached import build_frame_cache, render_cached

# Polynomial fit of the Turbo colormap (Google AI blog, 2019).
_TURBO_COEFFS = np.array(
    [
        [0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943],
        [0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604],
        [0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973],
    ]
)


def turbo_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0,1] -> rgb [.., 3]."""
    x = np.clip(x, 0.0, 1.0)
    powers = np.stack([np.ones_like(x), x, x**2, x**3, x**4, x**5], axis=-1)
    return np.clip(powers @ _TURBO_COEFFS.T, 0.0, 1.0)


def _stderr_log(msg: str):
    print(f"[tpugs_torch.viewer] {msg}", file=sys.stderr)


@dataclasses.dataclass
class FrameStats:
    """One rendered frame: its pair count, busiest tile and render time
    (CUDA events on the card, the host clock on the CPU). path: "exact"
    (render_arrays), "anchor" (a cached frame that built its anchor first)
    or "cached" (a cached frame on an earlier anchor, whose pair count and
    busiest tile it shows)."""

    width: int
    height: int
    num_pairs: int
    max_tile_hits: int
    ms: float
    path: str = "exact"


def _frame_clock(dev: torch.device):
    """Start a frame's clock on `dev`; the returned function stops it and
    gives the ms: CUDA events on the device's current stream (named, so
    that a caller in any thread times the right device) after waiting for
    them, or the host clock on the CPU."""
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record(stream)

        def stop() -> float:
            t1.record(stream)
            t1.synchronize()
            return t0.elapsed_time(t1)

        return stop
    h0 = time.perf_counter()
    return lambda: (time.perf_counter() - h0) * 1e3


class OfflineRenderer:
    """Forward-only renderer that checks every frame's pair_overflow and
    hit_overflow flags, and then grows the capacities and renders again
    ("grow", default), warns ("warn") or raises ("error"); it never renders
    silently wrong. tile defaults to 32.

    render_interactive re-anchors its cached frame when the camera rotated
    more than reanchor_deg degrees or its center moved more than
    reanchor_shift_frac of its distance from the origin since the anchor,
    or after reanchor_frames cached frames (0: no frame limit). The
    dominant error of a cached frame is the anchor's tile membership going
    stale, which sets in at screen shifts of about half a tile. A drag
    that turns more than reanchor_deg a frame (the web page's, from 2 mouse
    pixels per round trip) re-anchors every frame, and such a frame costs
    the anchor build and a cached frame: more than the exact frame
    (render_arrays) it stands in for."""

    def __init__(self, params: dict, sh_degree: int = -1, tile: int = 32,
                 pair_capacity: int = 1 << 21, max_hits: int = 2048,
                 on_overflow: str = "grow", log=None, presort: str = "fastest",
                 reanchor_deg: float = 0.25, reanchor_shift_frac: float = 0.01,
                 reanchor_frames: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = params_from_numpy(
            {k: np.asarray(v) for k, v in params.items()}, self.device)
        n = self.params["means"].shape[0]
        self.alive = torch.ones(n, dtype=torch.bool, device=self.device)
        self.max_sh_degree = int(round(self.params["sh"].shape[-1] ** 0.5)) - 1
        self.sh_degree = (self.max_sh_degree if sh_degree < 0
                          else min(sh_degree, self.max_sh_degree))
        self.tile = tile
        self.pair_capacity = pair_capacity
        self.max_hits = max_hits
        if on_overflow not in ("grow", "warn", "error"):
            raise ValueError(f"unknown on_overflow policy {on_overflow!r}")
        self.on_overflow = on_overflow
        # "fastest": exact presort below N = 2^18, the quantized pair key
        # above (bounded same-bin depth reorder, for display only).
        self.presort = presort
        self.log = log if log is not None else _stderr_log
        self._warned = set()
        self.frame_stats: list[FrameStats] = []
        self.reanchor_deg = reanchor_deg
        self.reanchor_shift_frac = reanchor_shift_frac
        self.reanchor_frames = reanchor_frames
        # {"key", "cache", "vm", "intr", "age"} of the current anchor, and
        # its "num_pairs" and "max_tile_hits" as read at its build.
        self._icache = None

    def _cfg(self, h: int, w: int) -> RasterConfig:
        return RasterConfig(img_h=h, img_w=w, tile_h=self.tile,
                            tile_w=self.tile, pair_capacity=self.pair_capacity,
                            max_hits_per_tile=self.max_hits)

    def _handle_overflow(self, h, w, num_pairs, pair_of, tile_hits, hit_of):
        """Returns True if the capacities grew (the caller renders again)."""
        msg = (
            f"render {w}x{h} OVERFLOW: pairs {num_pairs}/{self.pair_capacity}"
            f", busiest tile {tile_hits}/{self.max_hits} "
            f"(back-most pairs dropped — image truncated)"
        )
        if self.on_overflow == "error":
            raise RuntimeError(msg)
        new_pairs, new_hits = self.pair_capacity, self.max_hits
        if self.on_overflow == "grow":
            if pair_of:
                new_pairs = max(new_pairs, -(-int(1.3 * num_pairs) // 512) * 512)
            if hit_of:
                new_hits = max(new_hits, -(-int(1.2 * tile_hits) // 128) * 128)
        if (new_pairs, new_hits) == (self.pair_capacity, self.max_hits):
            if (h, w) not in self._warned:
                self._warned.add((h, w))
                self.log(msg)
            return False
        self.log(
            msg + f" -> growing pair_capacity {self.pair_capacity}->"
            f"{new_pairs}, max_hits {self.max_hits}->{new_hits}"
        )
        self.pair_capacity, self.max_hits = new_pairs, new_hits
        self._icache = None  # its aligned layout is sized for the old ones
        return True

    def render_arrays(self, h: int, w: int, viewmat, intr, background,
                      sh_degree: int = -1):
        """Overflow-checked render -> (color, final_T, n_contrib) tensors.
        sh_degree >= 0 overrides the evaluation degree, capped at the
        model's. Appends the frame's FrameStats to self.frame_stats."""
        deg = self.sh_degree if sh_degree < 0 else min(sh_degree, self.max_sh_degree)
        dev = self.device
        vm = torch.as_tensor(np.asarray(viewmat, np.float32), device=dev)
        it = torch.as_tensor(np.asarray(intr, np.float32), device=dev)
        bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
        p = self.params
        clock = _frame_clock(dev)
        for _ in range(8):  # growth converges: capacities only increase
            out = render(p["means"], p["quats"], p["log_scales"],
                         p["opacity_logits"], p["sh"], self.alive, vm, it,
                         self._cfg(h, w), deg, bg, presort=self.presort,
                         need_grads=False)
            num_pairs, pair_of, tile_hits, hit_of = (
                int(out.num_pairs), bool(out.pair_overflow),
                int(out.max_tile_hits), bool(out.hit_overflow))
            if not (pair_of or hit_of):
                break
            if not self._handle_overflow(h, w, num_pairs, pair_of, tile_hits,
                                         hit_of):
                break
        ms = clock()
        # The frame's kernels have run: a contract violation found on the
        # card raises before the frame is returned.
        cuda_lib.check_guards()
        self.frame_stats.append(FrameStats(w, h, num_pairs, tile_hits, ms))
        return out.color, out.final_T, out.n_contrib

    def _needs_reanchor(self, state, vm: np.ndarray, intr: np.ndarray) -> bool:
        if not np.array_equal(state["intr"], intr):
            return True  # the FOV moved: footprints and binning changed
        if self.reanchor_frames and state["age"] >= self.reanchor_frames:
            return True
        a, b = state["vm"], vm
        ra, rb = a[:3, :3], b[:3, :3]
        cos = np.clip((np.trace(ra.T @ rb) - 1.0) * 0.5, -1.0, 1.0)
        if np.degrees(np.arccos(cos)) > self.reanchor_deg:
            return True
        ca, cb = -ra.T @ a[:3, 3], -rb.T @ b[:3, 3]
        return bool(np.linalg.norm(ca - cb)
                    > self.reanchor_shift_frac * (np.linalg.norm(ca) + 1e-9))

    def render_interactive(self, h: int, w: int, viewmat, intr, background,
                           sh_degree: int = -1):
        """Frame-coherent path for continuous camera motion -> (color,
        final_T) tensors (ops/render_cached.py): the pair list is built at
        an anchor camera, kept while the camera stays within the re-anchor
        thresholds, and each frame re-projects every pair exactly and runs
        only the forward compositor. A bounded approximation for display;
        never used by evaluation or training. The host reads: the anchor
        build's pair count and overflow scalars, and the frame's end
        (the clock's event, the guard check), as render_arrays makes.
        Appends the frame's FrameStats."""
        deg = self.sh_degree if sh_degree < 0 else min(sh_degree, self.max_sh_degree)
        key = (h, w, deg)
        dev = self.device
        vm = np.asarray(viewmat, np.float32)
        intr_np = np.asarray(intr, np.float32)
        vm_t = torch.as_tensor(vm, device=dev)
        it = torch.as_tensor(intr_np, device=dev)
        bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
        p = self.params
        clock = _frame_clock(dev)
        st = self._icache
        path = "cached"
        if (st is None or st["key"] != key
                or self._needs_reanchor(st, vm, intr_np)):
            path = "anchor"
            for _ in range(8):  # growth converges: capacities only increase
                cache = build_frame_cache(
                    p["means"], p["quats"], p["log_scales"],
                    p["opacity_logits"], p["sh"], self.alive, vm_t, it,
                    self._cfg(h, w), deg)
                num_pairs, pair_of, tile_hits = (
                    int(cache.num_pairs), bool(cache.pair_overflow),
                    int(cache.max_tile_hits))
                hit_of = tile_hits > self.max_hits
                if not (pair_of or hit_of):
                    break
                if not self._handle_overflow(h, w, num_pairs, pair_of,
                                             tile_hits, hit_of):
                    break
            st = {"key": key, "cache": cache, "vm": vm, "intr": intr_np,
                  "age": 0, "num_pairs": num_pairs, "max_tile_hits": tile_hits}
            self._icache = st
        color, final_t = render_cached(st["cache"], vm_t, it,
                                       self._cfg(h, w), bg)
        st["age"] += 1
        ms = clock()
        cuda_lib.check_guards()
        self.frame_stats.append(FrameStats(w, h, st["num_pairs"],
                                           st["max_tile_hits"], ms, path))
        return color, final_t

    def render_camera(self, cam: CameraInfo, mode: str = "rgb",
                      background=(0.0, 0.0, 0.0),
                      sh_degree: int = -1) -> np.ndarray:
        color, final_t, n_contrib = self.render_arrays(
            cam.height, cam.width, cam.world_to_camera(),
            cam.intrinsics_array(), background, sh_degree=sh_degree,
        )
        if mode == "rgb":
            return np.clip(color.cpu().numpy(), 0.0, 1.0)
        if mode == "depth":  # opacity proxy: 1 - final transmittance
            return turbo_colormap(1.0 - final_t.cpu().numpy())
        if mode == "heatmap":
            nc = n_contrib.cpu().numpy().astype(np.float32)
            return turbo_colormap(nc / max(nc.max(), 1.0))
        raise ValueError(f"unknown mode {mode}")

    def render_trajectory(self, cameras: Iterable[CameraInfo], out_dir: str,
                          mode: str = "rgb", background=(0.0, 0.0, 0.0)) -> list:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, cam in enumerate(cameras):
            img = self.render_camera(cam, mode, background)
            path = os.path.join(out_dir, f"frame_{i:04d}.png")
            Image.fromarray((img * 255).astype(np.uint8)).save(path)
            paths.append(path)
        return paths

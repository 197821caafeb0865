"""Where the time of the viewer's frames goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_viewer.py [--out chiprun_out/profile]

The scene and camera of chip_smoke.py's viewer phase: the render CLI's
1M gaussians (synthetic_params(seed=0, scale_range=(0.002, 0.015)), SH
degree 3) seen by its orbit's frame 0 at 1920x1080, tiles of 32, the
viewer's capacities grown by an exact first frame. After warm-up it
prints, for the cached frame (ops/render_cached.py::render_cached, 0.05
degrees from its anchor), the anchor build (build_frame_cache) and the
exact frame (render(presort="qkey", need_grads=False)):

  - the time per frame, CUDA events around 20 back-to-back frames;
  - a torch.profiler trace of 10 frames: the device's busy and idle
    shares of the window's wall time, and the top kernels and operators
    by device time;

and writes each profiler table under --out. Needs CUDA.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W, H, N = 1920, 1080, 1_000_000
TIMED, PROFILED = 20, 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from profile_torch_train_step import device_attr, print_profile
    from tpugs_torch.ops.render import render
    from tpugs_torch.ops.render_cached import build_frame_cache, render_cached
    from tpugs_torch.utils.synthetic import synthetic_params_numpy
    from tpugs_torch.viewer.camera import OrbitCamera
    from tpugs_torch.viewer.offline import OfflineRenderer

    dev = torch.device("cuda", 0)
    params = synthetic_params_numpy(N, seed=0, scale_range=(0.002, 0.015))
    cams = []
    for deg in (0.0, 0.05):
        cam = OrbitCamera.from_points(params["means"])
        cam.elevation = np.radians(15.0)
        cam.rotate(np.radians(deg), 0.0)
        cams.append(cam.build_camera(W, H))
    r = OfflineRenderer(params, device=dev, log=lambda m: None)
    r.render_camera(cams[0])  # grows the capacities as a viewer's first frame
    cfg = r._cfg(H, W)
    p = r.params
    scene = (p["means"], p["quats"], p["log_scales"], p["opacity_logits"],
             p["sh"], r.alive)
    vm0, vm1 = (torch.as_tensor(c.world_to_camera(), dtype=torch.float32,
                                device=dev) for c in cams)
    it = torch.as_tensor(cams[0].intrinsics_array(), device=dev)
    bg = torch.zeros(3, device=dev)
    cache = build_frame_cache(*scene, vm0, it, cfg, r.sh_degree)
    frames = {
        "cached": lambda: render_cached(cache, vm1, it, cfg, bg),
        "anchor": lambda: build_frame_cache(*scene, vm0, it, cfg, r.sh_degree),
        "exact": lambda: render(*scene, vm1, it, cfg, r.sh_degree, bg,
                                presort="qkey", need_grads=False),
    }
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi)
    print(f"{N} gaussians, {W}x{H}, tiles of 32: {int(cache.num_pairs)} pairs,"
          f" table {tuple(cache.static_attr.shape)}, capacity "
          f"{cfg.pair_capacity}, max hits {cfg.max_hits_per_tile}")
    os.makedirs(args.out, exist_ok=True)
    for name, fn in frames.items():
        for _ in range(3):
            fn()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(TIMED):
            fn()
        t1.record()
        torch.cuda.synchronize()
        print(f"{name} frame: {t0.elapsed_time(t1) / TIMED:.3f} ms "
              f"(CUDA events, {TIMED} frames back to back)")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            h0 = time.perf_counter()
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - h0) * 1e3
        events = print_profile(prof, PROFILED, wall_ms, f"{name} frame")
        with open(os.path.join(args.out, f"viewer_{name}_table.txt"), "w") as f:
            f.write(events.table(sort_by=device_attr(events), row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The render CLI's frames and the viewer's cached frames of one checkout's
tpugs_torch, saved so that two checkouts can be compared bit for bit, on
one NVIDIA GPU:

    python3 scripts/compare_torch_frames.py [--repo DIR] --out a.npz
    python3 scripts/compare_torch_frames.py --compare a.npz b.npz

The scene, cameras and capacities are chip_smoke.py's (this checkout's):
its 1M-gaussian SH-3 PLY at 1920x1080, tiles of 32, the render CLI's orbit
and pair capacity. The frames are the first --frames orbit frames through
OfflineRenderer.render_arrays (what the render CLI renders), and the
viewer's frames through OfflineRenderer.render_interactive at the CLI's
frame-0 camera (the anchor build's cached frame at zero delta) and turned
0.05 degrees (a cached frame that keeps the anchor): colour and final T
as float32. --repo names the checkout whose tpugs_torch renders (default:
this one). --compare prints, per frame, whether the two files hold the
same bits and the largest difference.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports tpugs_torch only when called)


def render(repo: str, frames: int) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from tpugs_torch.io.ply import read_gaussian_ply
    from tpugs_torch.viewer.camera import OrbitCamera, orbit_trajectory
    from tpugs_torch.viewer.offline import OfflineRenderer

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        _, ply = chip_smoke.cli_scene(tmp)
        model = read_gaussian_ply(ply)
    w, h = chip_smoke.CLI_W, chip_smoke.CLI_H
    kw = dict(tile=32, pair_capacity=chip_smoke.CLI_PAIR_CAPACITY,
              max_hits=chip_smoke.CLI_MAX_HITS, on_overflow="error",
              device="cuda")
    renderer = OfflineRenderer(model, **kw)
    for i, cam in enumerate(orbit_trajectory(model["means"], frames, w, h,
                                             elevation_deg=15.0)):
        color, final_t, _ = renderer.render_arrays(
            cam.height, cam.width, cam.world_to_camera(),
            cam.intrinsics_array(), (0.0, 0.0, 0.0))
        out[f"cli_frame_{i}_color"] = color.cpu().numpy()
        out[f"cli_frame_{i}_final_t"] = final_t.cpu().numpy()
    viewer = OfflineRenderer(model, **kw)
    base = OrbitCamera.from_points(model["means"])
    for deg in (0.0, 0.05):
        cam = chip_smoke.viewer_camera(base, deg)
        color, final_t = viewer.render_interactive(
            cam.height, cam.width, cam.world_to_camera(),
            cam.intrinsics_array(), (0.0, 0.0, 0.0))
        out[f"viewer_{deg}_deg_color"] = color.cpu().numpy()
        out[f"viewer_{deg}_deg_final_t"] = final_t.cpu().numpy()
    out["viewer_paths"] = np.asarray([s.path for s in viewer.frame_stats])
    return out


def compare(a_path: str, b_path: str) -> int:
    a, b = np.load(a_path), np.load(b_path)
    same_all = sorted(a.files) == sorted(b.files)
    for k in sorted(a.files):
        x, y = a[k], b[k]
        if x.dtype.kind in "US":
            same = np.array_equal(x, y)
            print(f"{k}: {x.tolist()} / {y.tolist()} {'equal' if same else 'DIFFER'}")
        else:
            same = x.shape == y.shape and x.tobytes() == y.tobytes()
            err = float(np.abs(x - y).max()) if x.shape == y.shape else None
            print(f"{k}: {'bit-identical' if same else 'DIFFER'} "
                  f"(max abs diff {err})")
        same_all &= same
    print("all frames bit-identical" if same_all else "frames differ")
    return 0 if same_all else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--out")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        ap.error("--out or --compare")
    np.savez(args.out, **render(args.repo, args.frames))
    return 0


if __name__ == "__main__":
    sys.exit(main())

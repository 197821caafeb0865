"""render CLI: render an orbit trajectory from a gaussian PLY, as
tpugs.apps.render does, on the card (or on the CPU with --device cpu).

  python -m tpugs_torch.apps.render -m model.ply -o frames/ [--frames 60]
      [--width 1280 --height 720] [--mode rgb|depth|heatmap]
      [-d colmap_dir] [--device cuda|cpu]

With -d it renders the dataset's test cameras (every 8th image, at their
own sizes) instead of an orbit.

Prints one line per frame: its pair count, busiest tile and render time.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("tpugs-torch-render")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-o", "--output", default="frames")
    p.add_argument("-d", "--data", default=None,
                   help="COLMAP dir: render its test cameras instead of an orbit")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--mode", choices=["rgb", "depth", "heatmap"], default="rgb")
    p.add_argument("--background", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--sh-degree", type=int, default=-1)
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--tile", type=int, default=32,
                   help="tile size (32 = default; 16 renders ~2.2x more pairs)")
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--max-hits", type=int, default=2048)
    p.add_argument("--on-overflow", choices=["grow", "warn", "error"],
                   default="grow",
                   help="capacity-overflow policy: grow = render again with "
                        "larger capacities (default), warn = log + truncate, "
                        "error = raise")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from tpugs_torch.io.ply import read_gaussian_ply
    from tpugs_torch.viewer.camera import orbit_trajectory
    from tpugs_torch.viewer.offline import OfflineRenderer

    model = read_gaussian_ply(args.model)
    renderer = OfflineRenderer(
        model, sh_degree=args.sh_degree, tile=args.tile,
        pair_capacity=args.pair_capacity, max_hits=args.max_hits,
        on_overflow=args.on_overflow, device=args.device,
    )
    if args.data:
        from tpugs_torch.data.dataset import Dataset

        cams = Dataset(args.data).test_cameras
    else:
        cams = orbit_trajectory(model["means"], args.frames, args.width,
                                args.height, elevation_deg=args.elevation)
    paths = renderer.render_trajectory(
        cams, args.output, mode=args.mode, background=tuple(args.background)
    )
    for i, st in enumerate(renderer.frame_stats):
        print(f"frame {i:04d}: {st.width}x{st.height} pairs {st.num_pairs} "
              f"max_tile_hits {st.max_tile_hits} ms {st.ms:.3f}")
    print(f"wrote {len(paths)} frames to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

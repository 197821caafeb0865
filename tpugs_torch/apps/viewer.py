"""viewer CLI, as tpugs.apps.viewer: the interactive web viewer, on the
card (or on the CPU with --device cpu).

  python -m tpugs_torch.apps.viewer -m model.ply [--port 8000]
      [--width 1280] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("tpugs-torch-viewer")
    p.add_argument("-m", "--model", required=True, help="Gaussian PLY")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--background", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--sh-degree", type=int, default=-1)
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
    from tpugs_torch.viewer.server import ViewerServer

    model = read_gaussian_ply(args.model)
    server = ViewerServer(
        model, width=args.width, height=args.height,
        background=tuple(args.background), sh_degree=args.sh_degree,
        tile=args.tile, pair_capacity=args.pair_capacity,
        max_hits=args.max_hits, on_overflow=args.on_overflow,
        device=args.device,
    )
    server.serve(args.host, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())

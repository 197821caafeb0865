"""eval CLI, as tpugs.apps.eval: load a gaussian PLY, render the dataset's
test views, report PSNR/SSIM and write metrics.json (the same keys), on
the card (or on the CPU with --device cpu).

  python -m tpugs_torch.apps.eval -m model.ply -d <colmap_dir> [-r N]
      [-o metrics.json] [--debug-checks] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("tpugs-torch-eval")
    p.add_argument("-m", "--model", required=True, help="gaussian PLY")
    p.add_argument("-d", "--data", required=True, help="COLMAP dataset dir")
    p.add_argument("-r", "--resolution-scale", type=int, default=1)
    p.add_argument("-o", "--output", default="metrics.json")
    p.add_argument("--sh-degree", type=int, default=-1, help="-1 = model max")
    p.add_argument("--tile", type=int, default=32, help="tile size (pixels)")
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--max-hits", type=int, default=2048)
    p.add_argument("--on-overflow", choices=["grow", "warn", "error"],
                   default="grow",
                   help="capacity-overflow policy: grow = render again with "
                        "larger capacities (default), warn = log + truncate, "
                        "error = raise")
    p.add_argument("--debug-checks", action="store_true",
                   help="render every view through utils.checks."
                        "checked_render: slow, raises naming the violated "
                        "compositor invariant")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tpugs_torch.data.dataset import Dataset
    from tpugs_torch.io.ply import read_gaussian_ply
    from tpugs_torch.ops.render import RasterConfig
    from tpugs_torch.train.metrics import evaluate_views
    from tpugs_torch.utils.checks import checked_render
    from tpugs_torch.viewer.offline import OfflineRenderer

    model = read_gaussian_ply(args.model)
    n = model["means"].shape[0]
    ds = Dataset(args.data, args.resolution_scale)
    if ds.num_test() == 0:
        print("no test cameras", file=sys.stderr)
        return 1
    # The renderer checks every view's overflow flags: it grows the
    # capacities and renders again, warns or raises (--on-overflow).
    renderer = OfflineRenderer(
        model, sh_degree=args.sh_degree, tile=args.tile,
        pair_capacity=args.pair_capacity, max_hits=args.max_hits,
        on_overflow=args.on_overflow, device=args.device)
    dev = renderer.device
    bg = np.zeros((3,), np.float32)
    views = [(cam.image_name, ds.load_test_image(i),
              (cam.height, cam.width, cam.world_to_camera(),
               cam.intrinsics_array()))
             for i, cam in enumerate(ds.test_cameras)]

    if args.debug_checks:
        def render_view(a):
            h, w, vm, intr = a
            cfg = RasterConfig(img_h=h, img_w=w, tile_h=args.tile,
                               tile_w=args.tile,
                               pair_capacity=renderer.pair_capacity,
                               max_hits_per_tile=renderer.max_hits)
            return checked_render(
                renderer.params, renderer.alive,
                torch.as_tensor(vm, dtype=torch.float32, device=dev),
                torch.as_tensor(intr, device=dev), cfg, renderer.sh_degree,
                bg)
    else:
        def render_view(a):
            return renderer.render_arrays(*a, bg)[0]

    results = evaluate_views(render_view, views, num_gaussians=n)
    for r in results.images:
        print(f"  {r.name}: PSNR {r.psnr:.2f} dB  SSIM {r.ssim:.4f}  "
              f"({r.render_ms:.1f} ms)")
    print(f"mean: PSNR {results.mean_psnr:.2f} dB  SSIM "
          f"{results.mean_ssim:.4f}  ({len(results.images)} views, {n} "
          f"gaussians)")
    results.save_json(args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

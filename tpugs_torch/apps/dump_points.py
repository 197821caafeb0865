"""dump_points CLI, as tpugs.apps.dump_points: the sparse points and the
train (green) and test (red) camera centers as a PLY, to check a dataset
by eye. The vertex table is put together in numpy, as the reference does;
--device is resolved as the other entry points resolve it, so the default
(cuda) raises where there is no card.

  python -m tpugs_torch.apps.dump_points -d <colmap_dir> -o points.ply
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser("tpugs-torch-dump-points")
    p.add_argument("-d", "--data", required=True)
    p.add_argument("-o", "--output", default="points.ply")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from tpugs_torch.data.dataset import Dataset
    from tpugs_torch.device import resolve_device
    from tpugs_torch.io.ply import write_points_ply

    resolve_device(args.device)
    ds = Dataset(args.data)
    pts = [ds.points_xyz]
    cols = [ds.points_rgb]
    for cams, color in ((ds.train_cameras, [0, 1, 0]),
                        (ds.test_cameras, [1, 0, 0])):
        if cams:
            pts.append(np.stack([c.camera_center() for c in cams]).astype(np.float32))
            cols.append(np.tile(np.asarray(color, np.float32), (len(cams), 1)))
    write_points_ply(args.output, np.concatenate(pts), np.concatenate(cols))
    print(f"wrote {args.output}: {sum(len(x) for x in pts)} vertices "
          f"({len(ds.points_xyz)} points, {ds.num_train()} train cams, "
          f"{ds.num_test()} test cams); extent={ds.scene_bounds.extent:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

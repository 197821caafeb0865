"""Quality benchmark, as tpugs.apps.quality: render a synthetic
ground-truth scene into a dataset, train on it from its sparse points
with ADC (or --mcmc), and report the test split's PSNR/SSIM, on the card
(or on the CPU with --device cpu).

  python -m tpugs_torch.apps.quality [-i 2000] [-o workdir]
      [--gaussians 8000] [--mcmc] [--device cuda|cpu]

Prints one JSON line and writes <workdir>/quality.json. --mesh
data=D,gauss=G trains on D*G ranks started by torchrun (see
apps/train.py); rank 0 writes the dataset into -o, which every rank reads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main(argv=None):
    p = argparse.ArgumentParser("tpugs-torch-quality")
    p.add_argument("-i", "--iterations", type=int, default=2000)
    p.add_argument("-o", "--workdir", default=None)
    p.add_argument("--gaussians", type=int, default=8000)
    p.add_argument("--views", type=int, default=24)
    p.add_argument("--width", type=int, default=488)
    p.add_argument("--height", type=int, default=272)
    p.add_argument("--capacity", type=int, default=1 << 15)
    p.add_argument("--mcmc", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--jitter", type=float, default=0.0,
                   help="per-view camera jitter (0-1)")
    p.add_argument("--rings", type=int, default=1,
                   help="orbit elevation rings")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--mesh", default="",
                   help="device mesh spec, e.g. data=2,gauss=2 (under "
                        "torchrun)")
    p.add_argument("--steps-per-call", type=int, default=25,
                   help="steps per block; events land up to K-1 steps after "
                        "the reference's per-step schedule (1 = exact)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from tpugs_torch.device import resolve_device
    from tpugs_torch.parallel.distributed import (maybe_init_distributed,
                                                  shutdown_distributed)

    device = resolve_device(args.device)
    started = maybe_init_distributed(device.type)
    try:
        return _run(args, device.type if started else device)
    finally:
        if started:
            shutdown_distributed()


def _run(args, device):
    from tpugs_torch.train.trainer import TrainConfig, Trainer
    from tpugs_torch.utils.gt_scene import make_gt_model, write_gt_dataset

    mesh = None
    if args.mesh:
        from tpugs_torch.parallel.dist_train import parse_mesh_spec

        mesh = parse_mesh_spec(args.mesh, device=device)
        device = mesh.device
        if mesh.size > 1 and not args.workdir:
            raise ValueError("--mesh over several ranks needs -o, a workdir "
                             "every rank reads")
    primary = mesh is None or mesh.primary
    workdir = args.workdir or tempfile.mkdtemp(prefix="tpugs_quality_")
    scene_dir = os.path.join(workdir, "scene")
    if primary:
        print(f"rendering ground-truth dataset -> {scene_dir}")
        model = make_gt_model(args.gaussians, seed=args.seed, device=device)
        write_gt_dataset(scene_dir, model, num_views=args.views,
                         width=args.width, height=args.height,
                         jitter=args.jitter, elevation_rings=args.rings)
        del model
    if mesh is not None:
        from tpugs_torch.parallel.comm import barrier

        barrier(mesh)  # the dataset is written

    cfg = TrainConfig(
        iterations=args.iterations, capacity=args.capacity, sh_degree=3,
        log_every=args.log_every, save_every=0, eval_every=args.eval_every,
        densify_mode="mcmc" if args.mcmc else "adc",
        output_dir=os.path.join(workdir, "out"),
        steps_per_call=args.steps_per_call, mesh=args.mesh)
    trainer = Trainer(scene_dir, cfg, device=device)
    trainer.train(args.iterations)

    results = trainer.evaluate()
    if not primary:
        return 0
    out = {
        "metric": "quality_psnr_synthetic_gt",
        "value": round(results.mean_psnr, 2),
        "unit": "dB PSNR (test split)",
        "ssim": round(results.mean_ssim, 4),
        "iterations": args.iterations,
        "num_gaussians": results.num_gaussians,
    }
    print(json.dumps(out))
    results.save_json(os.path.join(workdir, "quality.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

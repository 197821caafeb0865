"""train CLI, as tpugs.apps.train, on the card (or on the CPU with
--device cpu):

  python -m tpugs_torch.apps.train -d <colmap_dir> -o <out_dir> [options]
      [--mcmc | --no-densify] [--device cuda|cpu]

The same flags as the reference's CLI: ADC densification by default, MCMC
with --mcmc, none with --no-densify; --trace-dir writes a torch.profiler
Chrome trace of the training there. --mesh data=D,gauss=G trains on D*G
ranks, one per card, started by a launcher:

  torchrun --nproc-per-node G -m tpugs_torch.apps.train ... --mesh data=D,gauss=G

(NCCL on the card; with --device cpu, gloo ranks on the CPU). Across hosts,
parallel/distributed.py's TPUGS_* variables. Without a launcher a mesh
larger than 1x1 raises.
"""
from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser("tpugs-torch-train",
                                description="Train 3D Gaussian Splatting")
    p.add_argument("-d", "--data", required=True, help="COLMAP dataset dir")
    p.add_argument("-c", "--config", default=None,
                   help="JSON TrainConfig file; flags given on the command "
                        "line override its values")
    p.add_argument("-o", "--output", default="output", help="output dir")
    p.add_argument("-i", "--iterations", type=int, default=30000)
    p.add_argument("-r", "--resolution-scale", type=int, default=1)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--capacity", type=int, default=1 << 17,
                   help="fixed gaussian capacity")
    p.add_argument("--save-every", type=int, default=7000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--lambda", dest="lambda_ssim", type=float, default=0.2)
    p.add_argument("--random-bg", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-densify", action="store_true")
    p.add_argument("--mcmc", action="store_true")
    p.add_argument("--tile", type=int, default=32, help="tile size (pixels)")
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--max-hits", type=int, default=2048)
    p.add_argument("--densify-from", type=int, default=500)
    p.add_argument("--densify-until", type=int, default=15000)
    p.add_argument("--densify-every", type=int, default=100)
    p.add_argument("--grad-threshold", type=float, default=2e-4)
    p.add_argument("--final-opacity-reset", action="store_true",
                   help="keep the opacity reset at densify_until "
                        "(ADCConfig.skip_final_reset = False)")
    p.add_argument("--resume", default=None, help="resume from a ckpt_*.npz")
    p.add_argument("--mesh", default="",
                   help="device mesh spec for distributed training, e.g. "
                        "data=2,gauss=4 (one rank per card, under torchrun)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "training into this directory")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _given_args(argv):
    """The options given explicitly on the command line (so a --config
    file's values are overridden only by flags that are present)."""
    p = build_parser()
    for a in p._actions:
        a.default = argparse.SUPPRESS
        a.required = False
    return set(vars(p.parse_known_args(argv)[0]))


def config_from_args(args, given):
    import dataclasses as dc

    from tpugs_torch.train.trainer import TrainConfig, load_train_config

    cfg = load_train_config(args.config) if args.config else TrainConfig()
    field_map = {  # arg dest -> TrainConfig field
        "iterations": "iterations", "resolution_scale": "resolution_scale",
        "sh_degree": "sh_degree", "lambda_ssim": "lambda_ssim",
        "save_every": "save_every", "log_every": "log_every",
        "capacity": "capacity", "random_bg": "random_background",
        "seed": "seed", "pair_capacity": "pair_capacity",
        "max_hits": "max_hits_per_tile", "output": "output_dir",
        "mesh": "mesh",
    }
    over = {f: getattr(args, a) for a, f in field_map.items() if a in given}
    if "tile" in given:
        over["tile_h"] = over["tile_w"] = args.tile
    if "mcmc" in given or "no_densify" in given or not args.config:
        over["densify_mode"] = (
            "mcmc" if args.mcmc else ("none" if args.no_densify else "adc"))
    adc_map = {"densify_from": "densify_from", "densify_until": "densify_until",
               "densify_every": "densify_every",
               "grad_threshold": "grad_threshold"}
    adc_over = {f: getattr(args, a) for a, f in adc_map.items() if a in given}
    if "final_opacity_reset" in given:
        adc_over["skip_final_reset"] = not args.final_opacity_reset
    if adc_over:
        over["adc"] = dc.replace(cfg.adc, **adc_over)
    return dc.replace(cfg, **over)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mcmc and args.no_densify:
        print("--mcmc and --no-densify are mutually exclusive", file=sys.stderr)
        return 2
    from tpugs_torch.device import resolve_device
    from tpugs_torch.parallel.distributed import (maybe_init_distributed,
                                                  shutdown_distributed)
    from tpugs_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    started = maybe_init_distributed(device.type)
    try:
        cfg = config_from_args(args, _given_args(argv))
        trainer = Trainer(args.data, cfg, resume_from=args.resume,
                          device=device.type if started else device)
        # history.jsonl is written by Trainer.train as it goes.
        if args.trace_dir:
            from tpugs_torch.utils.profiling import trace

            with trace(args.trace_dir):
                trainer.train()
        else:
            trainer.train()
    finally:
        if started:
            shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())

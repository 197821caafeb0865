"""Device and toolchain check, as tpugs.apps.info: the card's facts from
torch.cuda, a 128x128 matmul, and a one-tile render through render() (the
expand, align-copy and forward compositor kernels on the card).

  python -m tpugs_torch.apps.info [--json] [--device cuda|cpu]

Exits 1 when a smoke test fails, with its error in the output.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback


def _smoke(info: dict, name: str, fn) -> None:
    """info[name + "_ok"] = fn(); an exception is a failed test, its error
    reported under name + "_error" and its traceback on stderr."""
    try:
        info[f"{name}_ok"] = bool(fn())
    except Exception as e:  # a smoke test reports what failed
        traceback.print_exc(file=sys.stderr)
        info[f"{name}_ok"] = False
        info[f"{name}_error"] = f"{type(e).__name__}: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description="tpugs_torch device info / "
                                             "smoke test")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpugs_torch import cuda_lib
    from tpugs_torch.device import resolve_device
    from tpugs_torch.utils.memory import device_memory_stats

    dev = resolve_device(args.device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    info = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": str(dev),
        "device_count": count,
        "devices": [
            {"id": i, "name": torch.cuda.get_device_name(i),
             "capability": "{}.{}".format(*torch.cuda.get_device_capability(i)),
             "memory_mb": round(torch.cuda.get_device_properties(i).total_memory
                                / 2**20, 1)}
            for i in range(count)
        ],
    }
    stats = device_memory_stats(dev)
    if stats:
        info["hbm_limit_mb"] = round(stats["bytes_limit"] / 2**20, 1)
        info["hbm_in_use_mb"] = round(stats["bytes_in_use"] / 2**20, 1)

    def matmul():
        x = torch.ones((128, 128), dtype=torch.float32, device=dev)
        return torch.allclose((x @ x)[0, 0].cpu(), torch.tensor(128.0))

    def one_tile_render():
        from tpugs_torch.ops.render import RasterConfig, render
        from tpugs_torch.utils.synthetic import (synthetic_intrinsics,
                                                 synthetic_params)

        cfg = RasterConfig(img_h=16, img_w=16, tile_h=16, tile_w=16,
                           pair_capacity=1 << 10, max_hits_per_tile=64)
        p = synthetic_params(64, seed=0, device=dev)
        out = render(p["means"], p["quats"], p["log_scales"],
                     p["opacity_logits"], p["sh"],
                     torch.ones(64, dtype=torch.bool, device=dev),
                     torch.eye(4, device=dev),
                     synthetic_intrinsics(16, 16, device=dev), cfg, 0,
                     torch.zeros(3, device=dev), need_grads=False)
        ok = bool(torch.isfinite(out.color).all())
        cuda_lib.check_guards()  # the kernels ran (the read above waited)
        return ok

    _smoke(info, "matmul", matmul)
    _smoke(info, "render", one_tile_render)

    if args.json:
        print(json.dumps(info, indent=2))
    else:
        print(f"torch {info['torch_version']}  cuda {info['cuda_version']}  "
              f"device={info['device']}  devices={info['device_count']}")
        for d in info["devices"]:
            print(f"  [{d['id']}] {d['name']} (sm {d['capability']}, "
                  f"{d['memory_mb']:.0f} MB)")
        if "hbm_limit_mb" in info:
            print(f"HBM: {info['hbm_in_use_mb']:.0f} / "
                  f"{info['hbm_limit_mb']:.0f} MB in use")
        for name in ("matmul", "render"):
            err = info.get(f"{name}_error")
            print(f"{name} smoke: {'OK' if info[f'{name}_ok'] else 'FAIL'}"
                  + (f" ({err})" if err else ""))
    return 0 if info["matmul_ok"] and info["render_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

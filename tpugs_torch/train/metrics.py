"""Evaluation metrics, as in tpugs/train/metrics.py: PSNR, SSIM (the
training loss's windowed SSIM) and the per-view results with their JSON."""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from tpugs_torch.train.loss import ssim as ssim_map


def compute_psnr(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """10 log10(1 / MSE), at most 100 dB."""
    mse = torch.mean((rendered - target) ** 2)
    psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-10))
    return torch.clamp(psnr, max=100.0)


def compute_ssim(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM."""
    return torch.mean(ssim_map(rendered, target))


@dataclasses.dataclass
class ImageResult:
    name: str
    psnr: float
    ssim: float
    render_ms: float


@dataclasses.dataclass
class EvalResults:
    """Per-image and mean results."""

    images: list = dataclasses.field(default_factory=list)
    mean_psnr: float = 0.0
    mean_ssim: float = 0.0
    total_time_s: float = 0.0
    num_gaussians: int = 0

    def finalize(self):
        if self.images:
            self.mean_psnr = float(np.mean([r.psnr for r in self.images]))
            self.mean_ssim = float(np.mean([r.ssim for r in self.images]))
        return self

    def to_json(self) -> dict:
        return {
            "mean_psnr": self.mean_psnr,
            "mean_ssim": self.mean_ssim,
            "num_images": len(self.images),
            "num_gaussians": self.num_gaussians,
            "total_time_s": self.total_time_s,
            "images": [dataclasses.asdict(r) for r in self.images],
        }

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


def evaluate_views(render_fn, views, num_gaussians: int = 0,
                   render_named=None) -> EvalResults:
    """Render each (name, target image, view_args) and score it.

    render_fn(view_args) -> [H, W, 3] tensor; render_named(name,
    view_args), when given, takes its place (for callers that log per-view
    overflow). render_ms is the host time of the render up to a device
    synchronize on the card."""
    results = EvalResults(num_gaussians=num_gaussians)
    t0 = time.perf_counter()
    for name, target, view_args in views:
        ti = time.perf_counter()
        img = (render_named(name, view_args) if render_named is not None
               else render_fn(view_args))
        img = torch.clamp(img, 0.0, 1.0)
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        render_ms = (time.perf_counter() - ti) * 1e3
        tgt = torch.as_tensor(np.asarray(target, np.float32), device=img.device)
        results.images.append(ImageResult(
            name=name, psnr=float(compute_psnr(img, tgt)),
            ssim=float(compute_ssim(img, tgt)), render_ms=render_ms))
    results.total_time_s = time.perf_counter() - t0
    return results.finalize()

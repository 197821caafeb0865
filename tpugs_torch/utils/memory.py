"""Device-memory budgeting and the runtime watchdog, as in
tpugs/utils/memory.py, on the CUDA allocator's numbers: the card's total
memory (`torch.cuda.mem_get_info`) as the limit and
`torch.cuda.memory_allocated` as the memory in use. The CPU reports no
stats, and then the budget check only estimates and the watchdog is inert,
as the reference's are on a device without memory stats.
"""
from __future__ import annotations

import dataclasses

import torch

BYTES_F32 = 4


@dataclasses.dataclass
class MemoryEstimate:
    params_mb: float
    adam_mb: float
    pairs_mb: float
    image_mb: float
    total_mb: float

    def __str__(self):
        return (
            f"params {self.params_mb:.0f} MB + adam {self.adam_mb:.0f} MB + "
            f"pairs {self.pairs_mb:.0f} MB + images {self.image_mb:.0f} MB "
            f"= {self.total_mb:.0f} MB"
        )


def estimate_train_memory_mb(capacity: int, sh_coeffs: int = 16,
                             pair_capacity: int = 1 << 21, img_h: int = 1080,
                             img_w: int = 1920,
                             num_cached_images: int = 0) -> MemoryEstimate:
    """Lower-bound footprint of a training configuration: per gaussian
    3 + 4 + 3 + 1 + 3 C floats, x3 with Adam's moments; per pair 20 words;
    the image bank."""
    per_gauss = 3 + 4 + 3 + 1 + 3 * sh_coeffs
    params = capacity * per_gauss * BYTES_F32
    adam = 2 * params
    pairs = pair_capacity * (16 + 4) * BYTES_F32
    image = num_cached_images * img_h * img_w * 3 * BYTES_F32
    total = params + adam + pairs + image
    mb = 1.0 / (1024 * 1024)
    return MemoryEstimate(params_mb=params * mb, adam_mb=adam * mb,
                          pairs_mb=pairs * mb, image_mb=image * mb,
                          total_mb=total * mb)


def device_memory_stats(device=None) -> dict:
    """{"bytes_limit", "bytes_in_use"} of a CUDA device; {} for the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(dev)
    return {"bytes_limit": total,
            "bytes_in_use": torch.cuda.memory_allocated(dev)}


class MemoryWatchdog:
    """Reads the device's memory on the Trainer's logging cadence;
    `max_critical_streak` consecutive readings above the limit make
    `should_abort` true, and the Trainer checkpoints and stops.

    limit_mb = 0 takes the device's total less `auto_margin_mb`. Without
    stats (the CPU) the watchdog is inert unless `stats_fn` is given."""

    def __init__(self, limit_mb: float = 0.0, auto_margin_mb: float = 600.0,
                 critical_margin_mb: float = 200.0,
                 max_critical_streak: int = 5, stats_fn=None, log=print,
                 device=None):
        self._stats_fn = stats_fn or (lambda: device_memory_stats(device))
        self.log = log
        self.max_critical_streak = max_critical_streak
        self.critical_margin_mb = critical_margin_mb
        self.streak = 0
        self.last_used_mb = 0.0
        if limit_mb > 0:
            self.limit_mb = limit_mb
        else:
            limit = self._stats_fn().get("bytes_limit")
            self.limit_mb = (limit / (1024 * 1024) - auto_margin_mb
                             if limit else 0.0)
        self.enabled = self.limit_mb > 0

    def check(self) -> str:
        """One reading: "ok", "warning" or "critical"; updates the streak."""
        if not self.enabled:
            return "ok"
        used = self._stats_fn().get("bytes_in_use")
        if used is None:
            return "ok"
        self.last_used_mb = used / (1024 * 1024)
        if self.last_used_mb > self.limit_mb:
            self.streak += 1
            self.log(
                f"HBM CRITICAL: {self.last_used_mb:.0f} MB in use > limit "
                f"{self.limit_mb:.0f} MB (streak "
                f"{self.streak}/{self.max_critical_streak})"
            )
            return "critical"
        self.streak = 0
        if self.last_used_mb > self.limit_mb - self.critical_margin_mb:
            return "warning"
        return "ok"

    def should_abort(self) -> bool:
        return self.enabled and self.streak >= self.max_critical_streak


def check_memory_budget(capacity: int, sh_coeffs: int, pair_capacity: int,
                        img_h: int, img_w: int, num_cached_images: int,
                        headroom_mb: float = 512.0, device=None):
    """Raise MemoryError when the estimate cannot fit on the device."""
    est = estimate_train_memory_mb(capacity, sh_coeffs, pair_capacity, img_h,
                                   img_w, num_cached_images)
    limit = device_memory_stats(device).get("bytes_limit")
    if limit:
        limit_mb = limit / (1024 * 1024)
        if est.total_mb + headroom_mb > limit_mb:
            raise MemoryError(
                f"configuration needs ~{est.total_mb:.0f} MB + "
                f"{headroom_mb:.0f} MB headroom but the device has "
                f"{limit_mb:.0f} MB; reduce capacity, pair_capacity, or "
                f"resolution ({est})"
            )
    return est

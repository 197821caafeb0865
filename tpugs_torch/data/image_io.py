"""Image loading and resizing (PIL), as in tpugs/data/image_io.py: float32
[H, W, 3] in [0, 1], alpha dropped, bilinear resize."""
from __future__ import annotations

import numpy as np
from PIL import Image


def load_image(path: str) -> np.ndarray:
    """-> float32 [H, W, 3] in [0, 1]."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        return np.asarray(im, np.float32) / 255.0


def resize_image(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize of float [H, W, 3] in [0, 1] -> [new_h, new_w, 3]
    (through 8-bit, as the reference)."""
    im = Image.fromarray((np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    im = im.resize((new_w, new_h), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0


def load_image_resized(path: str, new_w: int, new_h: int) -> np.ndarray:
    """Load, resized to (new_w, new_h) when it differs."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (new_w, new_h):
            im = im.resize((new_w, new_h), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0

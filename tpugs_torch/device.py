"""Device resolution for the port's entry points: the card by default, the
CPU only when asked for, and never a silent fallback from one to the other."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """'cuda' (or None) -> the current CUDA device, raising when there is
    none; 'cpu' -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to "
                "run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_CONSTANTS: dict = {}


def device_constant(value, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor on `device`: a scalar for a number, a vector for a
    tuple of numbers. Made by fills, never by a copy from the host (which
    waits for the device), and cached per (value, dtype, device). One made
    during a CUDA graph capture belongs to that graph and is not cached."""
    dev = torch.device(device)
    key = (value, dtype, dev)
    t = _CONSTANTS.get(key)
    if t is not None:
        return t
    if isinstance(value, tuple):
        t = torch.stack([torch.full((), v, dtype=dtype, device=dev)
                         for v in value])
    else:
        t = torch.full((), value, dtype=dtype, device=dev)
    if not (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        _CONSTANTS[key] = t
    return t

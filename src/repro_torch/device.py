"""Device resolution for every entry point of the port.

The port is written for one CUDA card. An entry point given no device
runs on ``cuda``; it runs on the CPU only when the caller passes
``device="cpu"`` explicitly (the CPU tests do). With no device given and
no card present it raises — it never quietly picks the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the given device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def sync(device: torch.device) -> None:
    """Wait for queued device work (host timers around CUDA work need it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

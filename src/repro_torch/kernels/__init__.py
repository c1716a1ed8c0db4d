"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each ``kernels/<name>/`` holds ``ops.py`` (the wrapper: checks, output
allocation, launch on the current stream, launch counter) and ``ref.py``
(the plain PyTorch version of the same function). A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the
kernel or raises. ``impl="ref"`` forces the plain version — only the
tests and ``chip_smoke.py`` pass it.
"""
from __future__ import annotations

import importlib
from typing import Dict

KERNELS = ("ward_pool", "plaid_probe", "maxsim_packed", "maxsim",
           "maxsim_rerank", "kmeans_assign", "dequant_score")
IMPLS = ("auto", "ref")
# kernel -> (package under kernels/, counter in its ops.py); one source
# may hold several entries, each with its own counter
_COUNTERS = {"maxsim_rerank": ("maxsim", "RERANK_LAUNCHES"),
             "dequant_score": ("quant", "LAUNCHES")}


def _counter(name: str) -> "LaunchCounter":
    pkg, attr = _COUNTERS.get(name, (name, "LAUNCHES"))
    ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
    return getattr(ops, attr)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: _counter(name).count for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _counter(name).count = 0


class LaunchCounter:
    """A plain count of kernel launches, bumped by one wrapper."""

    def __init__(self) -> None:
        self.count = 0


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def check_cuda(name: str, **tensors) -> None:
    """All tensors on one CUDA device and contiguous, else raise."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_dtype(name: str, key: str, t, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")

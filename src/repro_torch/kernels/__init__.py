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
import threading
from typing import Dict

KERNELS = ("ward_pool", "plaid_probe", "maxsim_packed", "maxsim",
           "maxsim_rerank", "kmeans_assign", "dequant_score",
           "flash_attention")
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
        _counter(name).reset()


class LaunchCounter:
    """A count of kernel launches, bumped by one wrapper. Wrappers run
    from several threads at once (a sharded index probes its shards on a
    thread pool), so ``bump`` and ``reset`` take a lock."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def bump(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
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


def query_chunks(Lq: int, max_lq: int):
    """[lo, hi) ranges of at most ``max_lq`` query tokens covering Lq
    (one range when Lq <= max_lq)."""
    return [(lo, min(lo + max_lq, Lq)) for lo in range(0, max(Lq, 1), max_lq)]


def sum_over_query_chunks(fn, q, q_mask, max_lq: int):
    """``fn(q, q_mask)`` for a score that is a sum of per-query-token terms
    (a masked token adding 0, -inf staying -inf), taken over chunks of at
    most ``max_lq`` tokens and summed: exact up to f32 summation order.
    At Lq <= max_lq, one call on the tensors as given."""
    chunks = query_chunks(q.shape[1], max_lq)
    if len(chunks) == 1:
        return fn(q, q_mask)
    out = None
    for lo, hi in chunks:
        part = fn(q[:, lo:hi].contiguous(), q_mask[:, lo:hi].contiguous())
        out = part if out is None else out + part
    return out

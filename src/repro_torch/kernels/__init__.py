"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each ``kernels/<name>/`` holds ``ops.py`` (the wrapper: checks, output
allocation, launch on the current stream, launch counter) and ``ref.py``
(the plain PyTorch version of the same function). A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the
kernel or raises; given ``meta`` tensors (shapes only, as the dry run
traces a step) it traces the plain version, since no kernel runs on
``meta``. ``impl="ref"`` forces the plain version — only the
tests and ``chip_smoke.py`` pass it. ``ward_pool`` and ``plaid_probe``
also take the reference's ``impl="kernel"``, which launches the kernel
on a CUDA tensor and raises on any other.

The package exports the reference's five wrappers under its names
(``repro.kernels.__all__``). Three of them are also the names of
subpackages (``maxsim``, ``kmeans_assign``, ``flash_attention``): the
functions are bound last, after the subpackages are imported, so the
attribute is the function while ``from repro_torch.kernels.maxsim
import ops`` still finds the subpackage (``import
repro_torch.kernels.maxsim.ops as m`` does not: it walks attributes).
Importing a wrapper builds and loads nothing; a kernel is built at its
first launch. No kernel has a backward, so every
wrapper raises when autograd would record its call, and on a
``DTensor`` off ``meta`` (``check_inputs``).
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


def check_impl(impl: str, impls=IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"impl must be one of {impls}, got {impl!r}")


def plain_version(impl: str, t, name: str = "") -> bool:
    """True where a wrapper runs its plain version: ``impl="ref"``, or
    ``t`` on the CPU or on ``meta`` (a trace). Anything else takes the
    kernel's route, which launches on CUDA or raises. ``impl="kernel"``
    (``ward_pool`` and ``plaid_probe`` take it, as the reference's do)
    forces the kernel: on a CPU or ``meta`` tensor it raises, since the
    kernel runs only on the card."""
    if impl == "kernel":
        if t.device.type != "cuda":
            raise ValueError(
                f"{name}: impl='kernel' forces the CUDA kernel, which runs "
                f"only on the card; the input is on {t.device}")
        return False
    return impl == "ref" or t.device.type in ("cpu", "meta")


def check_inputs(name: str, *tensors) -> None:
    """Raise when autograd would record the call: grad mode on and an
    input that requires grad. No kernel has a backward (nor has its
    Pallas counterpart: no ``custom_vjp``), so a launch would hand back a
    tensor autograd cannot see through and drop the gradient silently on
    the card; the CPU's plain version raises too, so a CPU test shows
    what the card would do. Raise too on an input laid out over a mesh
    (a ``DTensor``) anywhere but on ``meta`` (a trace): a kernel reads
    one device's memory, so it neither gathers a sharded input nor falls
    back to its plain version; the caller hands it local shards."""
    import torch
    from torch.distributed.tensor import DTensor
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and neither package has a "
            f"backward for this kernel; call it under torch.no_grad() or "
            f"on tensors that do not require grad")
    if any(isinstance(t, DTensor) and t.device.type != "meta"
           for t in tensors):
        raise TypeError(
            f"{name}: an input is a DTensor laid out over a mesh; the "
            f"kernel reads one device's tensors, so call it on the local "
            f"shards (to_local())")


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


# the reference's exports, bound after every name above exists (the ops
# modules import them) and after the subpackages they shadow
from repro_torch.kernels.maxsim.ops import maxsim  # noqa: E402
from repro_torch.kernels.maxsim_packed.ops import (  # noqa: E402
    maxsim_packed_rerank)
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign  # noqa: E402
from repro_torch.kernels.quant.ops import dequant_score  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)

__all__ = ["maxsim", "maxsim_packed_rerank", "kmeans_assign",
           "dequant_score", "flash_attention"]

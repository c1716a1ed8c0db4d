"""The three-term roofline of the port, and the counts it reads from a
traced step (``src/repro/roofline/analysis.py``).

    compute term    = FLOPs / peak bf16 FLOP/s
    memory term     = bytes accessed / HBM bytes/s
    collective term = collective bytes / link bytes/s

each per rank, on the H100 of ``roofline/hw.py``. ``RooflineTerms``,
``model_flops_lm`` and ``model_flops_decode`` are the reference's.

The reference reads its counts from XLA: ``cost_analysis()`` for FLOPs
and bytes, the optimized HLO text for collectives
(``collective_bytes_from_hlo``, ``hlo_flops.dot_flops_in_hlo``). A
PyTorch step has no HLO; ``TraceCounter`` counts the same figures from
the aten ops a step dispatches, on ``meta`` tensors or real ones:

* FLOPs: ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` counts by), which price products and convolutions
  only, 2 per multiply-add: elementwise work, reductions and sorts count
  0, so a model without a product (``fm``'s cells) reads 0 here.
* Bytes accessed: each aten op's tensor inputs and outputs, summed, every
  op apart (views and ``empty`` allocations move nothing and count 0).
  An unfused upper bound: XLA counts what its fused kernels move, and a
  fusion reads its intermediates from registers, not from memory.
* Collective bytes: the result of each collective the step issues (the
  functional collectives DTensor redistributes with, and
  ``torch.distributed``'s in-place ones), under the reference's names
  (all-gather, all-reduce, reduce-scatter, all-to-all) and
  ``broadcast``; ``collective_bytes_from_trace`` sums them into the
  reference's ``{"total", "by_op"}`` form; ``largest_collective`` is
  the largest one's bytes.
* The peak of live activation bytes: every storage an op allocates is
  live from that op until the last tensor on it is freed (a weak
  reference on each tensor the ops return; a tensor autograd saves for
  the backward stays alive, so it is counted until the backward frees
  it); the tensors given to ``keep`` (a step's arguments) are never
  counted. What an allocator caches or rounds up is not seen.

Over DTensors (a rank's program, ``launch/dryrun.py`` stage 3) the
counter lets DTensor run first and sees the ops it runs on the local
shards: one rank's FLOPs, bytes, peak and collectives. The ops DTensor
runs on fake tensors to propagate shapes (under ``FakeTensorMode``) are
not counted. Over plain tensors at a cell's global shapes (stage 2) the
counts are the whole step's.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline import hw

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "broadcast")

# the collectives' op names (functional and in-place) -> the reference's
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_C10D = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd",
         "c10d")
_ALLOCATES_ONLY = ("empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided")


def tensors(tree):
    """The tensors of a tree of tensors, lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def nbytes(tree) -> int:
    """Bytes of the tensors of a tree (a view's own elements)."""
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class TraceCounter(TorchDispatchMode):
    """FLOPs, bytes accessed, collectives and the activation peak of the
    aten ops run under it (the module docstring says what each counts).
    ``keep``: tensors made before the trace (a step's arguments, a
    model's parameters; DTensors by their local shards), whose storages
    are never counted as activations. ``last_op`` is the last op it was
    given: where a trace stopped, the op that raised."""

    def __init__(self, keep=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.n_ops = 0
        self.by_op: Dict[str, Dict[str, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.largest_collective = 0
        self.last_op: Optional[str] = None
        self._keep = {_storage_key(_local(t)) for t in tensors(keep)}
        self._live: Dict[int, list] = {}      # storage -> [bytes, refs]
        self._refs: Dict[int, weakref.ref] = {}   # kept alive to fire

    # -- lifetimes ---------------------------------------------------------
    def _release(self, key, ref):
        self._refs.pop(id(ref), None)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self.live_bytes -= entry[0]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._keep:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        ref = weakref.ref(t, functools.partial(self._release, key))
        self._refs[id(ref)] = ref

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs first; its local ops come back here
            self.last_op = str(func)
            return NotImplemented
        if _fake_mode_active():         # DTensor's shape propagation
            return func(*args, **kwargs)
        self.last_op = str(func)
        out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func._overloadpacket
        namespace, _, name = packet._qualified_op_name.partition("::")
        if namespace in _C10D:
            coll = _COLLECTIVES.get(name)
            if coll is not None:
                moved = nbytes(args[0] if name.endswith("_") else out)
                entry = self.by_op.setdefault(coll, {"count": 0, "bytes": 0})
                entry["count"] += 1
                entry["bytes"] += moved
                self.largest_collective = max(self.largest_collective, moved)
        else:
            count = flop_registry.get(packet)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
            if not func.is_view and name not in _ALLOCATES_ONLY:
                self.bytes_accessed += nbytes((args, kwargs)) + nbytes(out)
        for t in tensors(out):
            if not isinstance(t, DTensor):
                self._track(t)
        return out


def collective_bytes_from_trace(counter: TraceCounter) -> Dict:
    """A traced rank's collectives in the reference's form: {"total":
    bytes, "by_op": {op: {"count": n, "bytes": b}}}, the bytes each
    collective's result holds, as ``collective_bytes_from_hlo`` sums
    result sizes."""
    by_op = {op: dict(counter.by_op[op]) for op in COLLECTIVE_OPS
             if op in counter.by_op}
    return {"total": sum(v["bytes"] for v in by_op.values()),
            "by_op": by_op}


@dataclass
class RooflineTerms:
    """The terms of one cell. ``collective_bytes`` None: not counted (a
    stage 3 that stopped), and the collective term is missing, never 0;
    the bottleneck and step time are then over the other two terms."""
    arch: str
    cell: str
    mesh: str
    flops: float                  # per-rank FLOPs
    hlo_bytes: float              # per-rank bytes accessed (HBM traffic)
    collective_bytes: Optional[float]   # per-rank collective traffic
    model_flops: float = 0.0      # 6*N*D useful flops (whole step, per rank)

    @property
    def compute_s(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / hw.HBM_BW

    @property
    def collective_s(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / hw.LINK_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms (perfect
        overlap of compute, HBM and links)."""
        return max(self._terms().values())

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-optimistic step time."""
        if self.step_time_s == 0:
            return 0.0
        return (self.model_flops / hw.PEAK_FLOPS_BF16) / self.step_time_s

    def row(self) -> str:
        coll = ("  missing" if self.collective_s is None
                else f"{self.collective_s:9.4f}")
        return (f"{self.arch:22s} {self.cell:14s} {self.mesh:9s} "
                f"{self.compute_s:9.4f} {self.memory_s:9.4f} "
                f"{coll} {self.bottleneck:10s} "
                f"{self.useful_flops_frac:6.1%} {self.mfu:6.1%}")


HEADER = (f"{'arch':22s} {'cell':14s} {'mesh':9s} {'compute_s':>9s} "
          f"{'memory_s':>9s} {'collect_s':>9s} {'bottleneck':10s} "
          f"{'useful':>6s} {'mfu':>6s}")


def model_flops_lm(cfg, cell_kind: str, n_tokens: int, n_chips: int,
                   seq_len: int = 0, batch: int = 0) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params;
    plus exact attention term 12*L*H*dh*S per token (causal halves it).
    Returned PER CHIP."""
    n_active = cfg.active_param_count()
    per_tok = (6 if cell_kind == "train" else 2) * n_active
    attn = 0
    if seq_len:
        mult = 6 if cell_kind == "train" else 2
        # qk^T + av: 2 matmuls of S x dh per head per token, causal ~ S/2
        eff_s = seq_len / 2 if cfg.causal else seq_len
        attn = mult * 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * eff_s
    return (per_tok + attn) * n_tokens / n_chips


def model_flops_decode(cfg, batch: int, seq_len: int, n_chips: int) -> float:
    """One decode step: 2*N_active per token + cache attention reads."""
    n_active = cfg.active_param_count()
    attn = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq_len
    return (2 * n_active + attn) * batch / n_chips


def from_dryrun(result: Dict, model_flops: float = 0.0) -> RooflineTerms:
    """A ``launch/dryrun.run_cell`` result's per-rank figures -> the
    terms (a stopped stage 3's collective term missing: None)."""
    return RooflineTerms(
        arch=result["arch"], cell=result["cell"], mesh=result["mesh"],
        flops=result["flops"], hlo_bytes=result["bytes_accessed"],
        collective_bytes=result["collective_bytes"],
        model_flops=model_flops)

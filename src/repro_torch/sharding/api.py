"""Logical-axis sharding constraints (``src/repro/sharding/api.py``).

Model code names a tensor's axes logically (``constrain(x, "batch",
"seq", "heads", None)``); a ``MeshContext`` maps logical names to mesh
axes by a rule table. With no context every annotation is a no-op, so
one piece of code runs on one device and on a mesh unchanged.

``PartitionSpec`` (``P``) is the port's spec: a tuple, one entry a
tensor dim, each ``None`` (replicated), a mesh axis name, or a tuple of
axis names (the dim split over several mesh axes, the first the major
one), as JAX's ``PartitionSpec``. ``placements`` turns a spec into the
DTensor placements of a ``DeviceMesh`` (one ``Shard(dim)`` on each mesh
dim a tensor dim names, ``Replicate()`` elsewhere); ``constrain``
redistributes a ``DTensor`` (or a plain tensor, taken as the same value
on every rank) to them, and its gradient likewise (``lay_out``: the
transpose of ``with_sharding_constraint``). ``split_last`` and
``merge_last`` take a head view the mesh may not divide (12 heads over
16 ranks): laid out before the view so DTensor can take it.
``reshard`` is DTensor's own ``redistribute`` (the gradient back to
the input's layout) and ``from_local`` a ``DTensor`` from a rank's
local result, for the models' code that runs on local shards.
``local_index`` and ``from_host`` lay out a host array that every rank
holds whole (a batch, a checkpoint's leaf), each rank taking its own
slice, so nothing moves between ranks. ``rank_context`` is one rank's
program over a mesh: the rules active and a plain tensor taken as
replicated.

The rule tables are the reference's: ``lm_rules`` (heads-TP, or
``attn_shard="sequence"`` for head counts the TP axis does not divide),
``lm_decode_rules``, ``lm_long_decode_rules``, ``gnn_rules``,
``recsys_rules``, ``serve_rules`` and ``retrieval_rules``. A
``model_axis`` of None (a mesh without one: the 1-D host mesh) maps
what the tables name on it to no axis.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]

_STATE = threading.local()


class PartitionSpec(tuple):
    """``P(None, "model", ("pod", "data"))``: one entry a tensor dim."""

    def __new__(cls, *entries):
        for e in entries:
            ok = e is None or isinstance(e, str) or (
                isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            if not ok:
                raise TypeError(f"spec entry {e!r} is not None, an axis name "
                                f"or a tuple of axis names")
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P({', '.join(repr(e) for e in self)})"


P = PartitionSpec


@dataclass
class MeshContext:
    mesh: object                       # a DeviceMesh or a DeviceGrid
    rules: Dict[str, Axis] = field(default_factory=dict)

    def resolve(self, name: Optional[str]) -> Axis:
        if name is None:
            return None
        return self.rules.get(name, None)


def current_ctx() -> Optional[MeshContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def mesh_context(mesh, rules: Dict[str, Axis]):
    """``rules`` over ``mesh`` for the block (this thread only)."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = MeshContext(mesh, dict(rules))
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def logical_spec(*names: Optional[str]) -> P:
    ctx = current_ctx()
    if ctx is None:
        return P()
    return P(*[ctx.resolve(n) for n in names])


def placements(spec, mesh) -> tuple:
    """A spec -> the DTensor placements of ``mesh`` (one a mesh dim).
    A tuple entry must name its axes in the mesh's order (a major axis
    first, as DTensor splits a dim over mesh dims in their order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            out[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {axes} not in the mesh's axis "
                             f"order {names}")
    return tuple(out)


def _layout(ctx: MeshContext, ndim: int, names) -> tuple:
    """The placements ``names`` give a tensor of ``ndim`` dims; a rule's
    mesh axis that this mesh lacks (``experts`` -> ``model`` on a
    ``("data",)`` mesh) leaves its dim replicated."""
    from torch.distributed.device_mesh import DeviceMesh
    if len(names) != ndim:
        raise ValueError(f"{len(names)} axis names for a tensor of "
                         f"{ndim} dims")
    if not isinstance(ctx.mesh, DeviceMesh):
        raise TypeError(f"constrain needs a DeviceMesh context, got "
                        f"{type(ctx.mesh).__name__}")
    have = set(ctx.mesh.mesh_dim_names)
    spec = []
    for n in names:
        axis = ctx.resolve(n)
        axes = [a for a in ((axis,) if isinstance(axis, str) else axis or ())
                if a in have]
        spec.append(tuple(axes) if len(axes) > 1 else
                    axes[0] if axes else None)
    return placements(P(*spec), ctx.mesh)


def lay_out(x, mesh, target):
    """``x`` (a ``DTensor``, or a plain tensor taken as the same value on
    every rank) laid out as ``target``; its gradient is laid out as
    ``target`` too, as the transpose of JAX's ``with_sharding_constraint``
    is the same constraint on the cotangent (a partial-sum gradient is
    reduced there: Megatron's backward all-reduce at the layer edge)."""
    return _LayOut.apply(_dtensor(x, mesh), mesh, tuple(target))


def _dtensor(x, mesh):
    """``x``, a plain tensor taken as the same value on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _LayOut(torch.autograd.Function):
    """``redistribute`` whose backward lays the gradient out as the
    forward's target (``lay_out``)."""

    @staticmethod
    def forward(ctx, t, mesh, target):
        ctx.mesh, ctx.target = mesh, target
        if tuple(t.placements) == target:
            return t.view_as(t)
        return t.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.target:
            g = g.redistribute(ctx.mesh, ctx.target)
        return g, None, None


def reshard(x, mesh, target):
    """``x`` laid out as ``target`` by DTensor's own ``redistribute``,
    whose gradient goes back to ``x``'s layout (a view's backward needs
    the layout its forward had); a plain tensor taken as replicated."""
    x = _dtensor(x, mesh)
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(mesh, target)


def from_local(local, mesh, place, shape, grad_placements=None):
    """A ``DTensor`` of global ``shape`` (contiguous strides, so ``local``
    is made contiguous) from this rank's ``local`` tensor laid out as
    ``place``; ``grad_placements`` the layout its gradient is brought to
    before it goes back to ``local`` (by default ``place``, a partial
    sum's replicated: the same on every rank)."""
    strides, acc = [], 1
    for n in reversed(tuple(shape)):
        strides.append(acc)
        acc *= int(n)
    spec = (mesh, tuple(place), tuple(shape), tuple(reversed(strides)))
    return _FromLocal.apply(local.contiguous(), spec,
                            None if grad_placements is None
                            else tuple(grad_placements))


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose backward lays the gradient out as
    asked before taking its local part (the same on every torch)."""

    @staticmethod
    def forward(ctx, local, spec, grad_placements):
        from torch.distributed.tensor import DTensor, Replicate
        mesh, place, shape, stride = spec
        ctx.mesh = mesh
        ctx.grad = grad_placements or tuple(
            Replicate() if p.is_partial() else p for p in place)
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.grad):
            g = g.redistribute(ctx.mesh, ctx.grad)
        return g.to_local(), None, None


def local_index(shape, mesh, place) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of global ``shape`` laid out as
    ``place`` over ``mesh`` (``Shard`` splits as ``torch.chunk`` does)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, tuple(place))
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's shards of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def from_host(array, mesh, place, device=None):
    """A ``DTensor`` of a host array's global shape laid out as
    ``place``, every rank holding the whole array and taking its own
    slice (``local_index``) to ``device`` (default the mesh's): no
    traffic between ranks."""
    from torch.distributed.tensor import DTensor
    t = torch.as_tensor(array)
    local = t[local_index(t.shape, mesh, place)].to(
        device or _mesh_device(mesh)).contiguous()
    return DTensor.from_local(local, mesh, tuple(place), run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


@contextlib.contextmanager
def rank_context(mesh, rules):
    """One rank's program over ``mesh``: the rules' annotations active
    (``mesh_context``) and a plain tensor a step makes (a mask, an
    ``arange``) taken as the same value on every rank
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with mesh_context(mesh, rules), implicit_replication():
        yield


def constrain(x, *names: Optional[str]):
    """``x`` unchanged with no context; under one, a ``DTensor`` of the
    names' placements on the context's ``DeviceMesh``: a ``DTensor``
    redistributed (a partial sum reduced: all-reduce or reduce-scatter),
    a plain tensor taken as the same value on every rank (replicated)
    and then laid out; a plain tensor the names replicate is that
    already, and comes back unchanged."""
    ctx = current_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    target = _layout(ctx, x.ndim, names)
    if not isinstance(x, DTensor) and not any(p.is_shard() for p in target):
        return x
    return lay_out(x, ctx.mesh, target)


def split_last(x, n: int, *names: Optional[str]):
    """``x`` [..., n * m] viewed as [..., n, m]; under a context laid out
    as ``names`` (the view's logical names) after the view. DTensor
    views a sharded last dim only where its mesh dims divide ``n``; where
    one does not (12 heads over 16 ranks, 8 kv heads over 16), ``x`` is
    first laid out as the view's target with that mesh dim replicated,
    then sliced after the view (XLA's partitioner does the same). A dim
    the target shards elsewhere (``qseq``) is resharded before the view,
    so the view itself moves nothing."""
    shape = (*x.shape[:-1], n, x.shape[-1] // n)
    ctx = current_ctx()
    if ctx is None:
        return x.view(shape)
    from torch.distributed.tensor import Replicate, Shard
    mesh = ctx.mesh
    target = _layout(ctx, len(shape), names)
    d = x.ndim - 1
    pre = [(p if not p.is_shard() or p.dim < d
            else Shard(d) if p.dim == d and n % mesh.size(i) == 0
            else Replicate()) for i, p in enumerate(target)]
    return reshard(reshard(x, mesh, pre).view(shape), mesh, target)


def merge_last(x, *names: Optional[str]):
    """``x`` [..., n, m] viewed as [..., n * m] (``reshape``); under a
    context laid out as ``names`` after it: where a mesh dim shards the
    n axis unevenly it is gathered before the merge and sliced after."""
    shape = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    ctx = current_ctx()
    if ctx is None:
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    mesh = ctx.mesh
    target = _layout(ctx, len(shape), names)
    d, n = x.ndim - 2, x.shape[-2]
    pre = [(Shard(d) if p.is_shard() and p.dim == d
            and n % mesh.size(i) == 0
            else Replicate() if p.is_shard() and p.dim >= d else p)
           for i, p in enumerate(target)]
    return reshard(reshard(x, mesh, pre).reshape(shape), mesh, target)


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------
def _with_model(batch_axes: Axis, model_axis: Optional[str]) -> Axis:
    axes = ((batch_axes,) if isinstance(batch_axes, str)
            else tuple(batch_axes or ())) + (
        (model_axis,) if model_axis else ())
    return axes if len(axes) > 1 else axes[0] if axes else None


def lm_rules(batch_axes: Axis = "data",
             model_axis: Optional[str] = "model",
             attn_shard: str = "heads") -> Dict[str, Axis]:
    """Megatron-style TP + DP rules for LM transformers.

    ``attn_shard="sequence"`` is the fallback for head counts that do not
    divide the TP degree (e.g. qwen2.5-14b H=40 on tp=16): the query
    sequence axis is model-sharded instead and KV is replicated across TP.
    """
    rules: Dict[str, Axis] = {
        "batch": batch_axes,
        "seq": None,
        "dmodel": None,
        "ff": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "kv": None,            # kv heads replicated across TP (kv < tp)
        "dh": None,
        "kvseq": None,
        "qseq": None,
        "heads": model_axis,
        # prefill cache emission: the cache's seq axis CAN shard over TP
        # (unlike attention's in-flight kv, which is head-sharded)
        "cacheseq": model_axis,
    }
    if attn_shard == "sequence":
        rules["heads"] = None
        rules["qseq"] = model_axis
    return rules


def lm_decode_rules(batch_axes: Axis = "data",
                    model_axis: Optional[str] = "model") -> Dict[str, Axis]:
    """Decode: flash-decoding style — KV cache sequence-sharded over TP,
    queries (1 token) replicated; exact softmax combine via all-reduce."""
    return {
        "batch": batch_axes,
        "seq": None,
        "dmodel": None,
        "ff": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "heads": None,
        "kv": None,
        "dh": None,
        "kvseq": model_axis,
        "qseq": None,
    }


def lm_long_decode_rules(batch_axes: Axis = "data",
                         model_axis: Optional[str] = "model"
                         ) -> Dict[str, Axis]:
    """long_500k (batch=1): the KV cache sequence axis is the ONLY big axis
    — shard it over every mesh axis (data+model combined)."""
    r = lm_decode_rules(batch_axes, model_axis)
    r["kvseq"] = _with_model(batch_axes, model_axis)
    r["batch"] = None
    return r


def gnn_rules(batch_axes: Axis = "data",
              model_axis: Optional[str] = "model") -> Dict[str, Axis]:
    """Node tables shard on data; edge/triplet tables (the big ones) shard
    over data+model combined — DimeNet's triplet tensors dwarf everything."""
    axes = _with_model(batch_axes, model_axis)
    return {
        "nodes": batch_axes,
        "edges": axes,
        "triplets": axes,
        "batch": batch_axes,
        "feat": None,
        "hidden": None,
    }


def recsys_rules(batch_axes: Axis = "data",
                 model_axis: Optional[str] = "model") -> Dict[str, Axis]:
    return {
        "batch": batch_axes,
        "vocab_rows": model_axis,   # embedding tables row-sharded over TP
        "embed": None,
        "feat": None,
        "candidates": batch_axes,   # retrieval_cand: 1M candidates, data
    }


def serve_rules(shard_axis: str = "shard",
                replica_axis: str = "replica") -> Dict[str, Axis]:
    """Scale-out serving (``launch/mesh.make_serve_mesh``): the doc axis
    partitions over the shard axis inside a replica group; queries are
    replicated (every shard scores the whole microbatch, the top-k merge
    is the only exchange). The batch axis maps to the replica axis only
    for router-level accounting — the engine routes whole microbatches
    to replica groups rather than splitting rows."""
    return {
        "docs": shard_axis,
        "queries": None,
        "tokens": None,
        "dim": None,
        "centroids": None,
        "batch": replica_axis,
    }


def retrieval_rules(batch_axes: Axis = "data",
                    model_axis: Optional[str] = "model") -> Dict[str, Axis]:
    return {
        "docs": _with_model(batch_axes, model_axis),  # docs over EVERY axis
        "queries": None,            # queries replicated
        "tokens": None,
        "dim": None,
        "batch": batch_axes,
        "seq": None,
        "heads": model_axis,
        "ff": model_axis,
        "vocab": model_axis,
        "dmodel": None,
        "kv": None,
        "dh": None,
        "experts": model_axis,
        "qseq": None,
        "kvseq": None,
        "centroids": None,
    }

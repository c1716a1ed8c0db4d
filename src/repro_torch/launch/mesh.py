"""Device meshes of the port (``src/repro/launch/mesh.py``).

Two kinds, with the reference's axis names:

* Meshes of ranks: ``torch.distributed``'s ``DeviceMesh`` over the ranks
  of the default process group, one device a rank. Single pod
  (data=16, model=16) = 256 ranks; multi-pod (pod=2, data=16,
  model=16) = 512, the ``pod`` axis pure data parallelism
  (``make_production_mesh``); ``("data",)`` over every rank
  (``make_host_mesh``); any shape (``make_mesh``, e.g. the one-rank
  ``("data", "model")`` mesh of one card). A ``DeviceMesh`` needs an
  initialized default group: ``process_group`` opens one for a block
  (NCCL on the card, gloo on the CPU; one rank from an in-process
  ``HashStore``, several from a store the caller passes) and destroys
  it after, so nothing leaks into the next caller of the process;
  ``fake_process_group`` opens torch's fake backend (no communication)
  at any world size, which is how the production meshes are built on a
  machine without 256 ranks.
* Grids of one process's devices (``DeviceGrid``): the scale-out serving
  mesh ``("replica", "shard")`` (``make_serve_mesh``) and one replica
  group's row ``("shard",)`` (``make_shard_mesh``). The reference's
  serve meshes are one process's devices too; ``core/replicated.py``'s
  flat plan places a group's shard tensors along the ``shard`` axis.

``serve_device_table`` tiles (replica, shard) cells over the cards
round-robin when there are fewer cards than cells; ``distinct_row``
says whether a row reuses none, the precondition of a shard grid over
it. ``batch_axes`` and ``fsdp_axes`` name a mesh's data-parallel axes,
``model_axis`` its tensor-parallel one (None on the host mesh).

Importing this module touches no device and opens no group.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class DeviceGrid:
    """Devices of this process laid out on named axes: ``devices`` is a
    nested tuple of ``shape`` (row-major), ``mesh_dim_names`` the axes."""
    devices: tuple
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (a ``DeviceMesh`` or a
    ``DeviceGrid``)."""
    return int(mesh.shape[tuple(mesh.mesh_dim_names).index(name)])


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------
def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(device: DeviceLike = None, *, world_size: int = 1,
                  rank: int = 0, store=None, init_method: str = None,
                  timeout: float = None):
    """The default process group for the block: NCCL on the card, gloo
    on the CPU; one rank from an in-process ``HashStore`` unless a
    ``store`` (a ``FileStore`` or ``TCPStore`` every rank shares) or an
    ``init_method`` (``"env://"`` under ``torchrun``) is given.
    ``timeout``: seconds a collective waits for a rank that is gone
    before it raises (torch's default when None). Destroyed on exit.
    Raises if a default group is open already (nothing is nested,
    nothing leaks)."""
    import datetime
    import torch.distributed as dist
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group is open already")
    if store is None and init_method is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks need a shared store")
        store = dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else rank)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(_backend(dev), store=store,
                            init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """torch's fake backend as the default group for the block: every
    collective returns at once and moves nothing, so a mesh of any size
    is built (and a program traced) by one process. Destroyed on exit."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is open already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Meshes of ranks
# ---------------------------------------------------------------------------
def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over every rank of the default group
    (whose size must be the shape's product), axes named ``axes``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an open default process group "
                           "(process_group or fake_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """(data=16, model=16), or (pod=2, data=16, model=16) multi-pod:
    needs a group of 256 (512) ranks, e.g. ``fake_process_group(256)``."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None):
    """Every rank of the default group as a 1-D ``("data",)`` mesh."""
    import torch.distributed as dist
    return make_mesh((dist.get_world_size(),), ("data",), device)


# ---------------------------------------------------------------------------
# Grids of one process's devices
# ---------------------------------------------------------------------------
def _local_devices(device: DeviceLike) -> List[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_serve_mesh(n_replicas: int, n_shards: int,
                    device: DeviceLike = None) -> DeviceGrid:
    """The scale-out serving grid, axes ("replica", "shard"): replica
    groups are throughput parallelism, the shard axis partitions the
    corpus inside a group. Needs ``n_replicas * n_shards`` devices; use
    ``serve_device_table`` when there are fewer."""
    if n_replicas < 1 or n_shards < 1:
        raise ValueError(f"need n_replicas, n_shards >= 1, got "
                         f"{n_replicas}, {n_shards}")
    devs = _local_devices(device)
    need = n_replicas * n_shards
    if len(devs) < need:
        raise ValueError(f"serve mesh ({n_replicas} replicas x {n_shards} "
                         f"shards) needs {need} devices, there are "
                         f"{len(devs)}")
    rows = tuple(tuple(devs[r * n_shards:(r + 1) * n_shards])
                 for r in range(n_replicas))
    return DeviceGrid(rows, (n_replicas, n_shards), ("replica", "shard"))


def make_shard_mesh(devices: Sequence) -> DeviceGrid:
    """A 1-D ("shard",) grid over one replica group's device row."""
    row = tuple(torch.device(d) for d in devices)
    return DeviceGrid(row, (len(row),), ("shard",))


def serve_device_table(n_replicas: int, n_shards: int,
                       device: DeviceLike = None) -> List[List[torch.device]]:
    """Devices of the (replica, shard) cells: ``table[r][s]``, tiling
    the cards round-robin when there are fewer than ``n_replicas *
    n_shards`` (the whole table on one card when there is one); a CPU
    ``device`` gives the CPU for every cell."""
    if n_replicas < 1 or n_shards < 1:
        raise ValueError(f"need n_replicas, n_shards >= 1, got "
                         f"{n_replicas}, {n_shards}")
    devs = _local_devices(device)
    return [[devs[(r * n_shards + s) % len(devs)] for s in range(n_shards)]
            for r in range(n_replicas)]


def distinct_row(row) -> bool:
    """True when a replica group's device row reuses no device."""
    devs = [torch.device(d) for d in row]
    return len(set(devs)) == len(devs)


def batch_axes(mesh):
    """The data-parallel axis spec: ("pod", "data") or "data"."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def fsdp_axes(mesh):
    """Weight-sharding (ZeRO) axes: the data-parallel axes."""
    return batch_axes(mesh)


def model_axis(mesh):
    """The tensor-parallel axis, ``"model"``, or None on a mesh without
    one (the 1-D host mesh), where the rules' ``model`` maps to none."""
    return "model" if "model" in mesh.mesh_dim_names else None

"""ReplicatedIndex: one logical index served as ``n_replicas`` replica
groups, each a search lane of the serving engine (counterpart of
``src/repro/core/replicated.py``).

Replicas may share ONE inner index object (``replicate``: no extra host
or device memory) or hold distinct copies (``from_dir``: one reopen of
the artifact a group, each loaded onto its group's device). Every lane
returns the same results as the wrapped index's ``search_batch``, so
the engine's router picks a lane for throughput only.

Placement: ``serve_device_table`` tiles the (replica, shard) cells over
``cuda:0 .. cuda:n-1`` round-robin (a copy of the reference's
``launch/mesh.serve_device_table``). On one card every group lands on
``cuda:0``: the reference's single-device ("degraded") regime, with lane
concurrency only. A sharded inner's shards probe under their row's
devices (``ShardedIndex.place``).

Not ported: the reference's SPMD flat plan (``_FlatPlan``, a
``shard_map`` program over a JAX mesh, which needs ``sharding/*``).
``use_shard_map=True`` raises; ``None`` (auto) and ``False`` serve every
backend through the per-lane dispatch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.sharded import ShardedIndex
from repro_torch.device import DeviceLike, resolve_device


def serve_device_table(n_replicas: int, n_shards: int,
                       device: DeviceLike = None) -> List[List[torch.device]]:
    """Devices of the (replica, shard) cells: ``table[r][s]``, tiling
    the CUDA cards round-robin (the whole table on one card when there is
    one); a CPU ``device`` gives the CPU for every cell."""
    if n_replicas < 1 or n_shards < 1:
        raise ValueError(f"need n_replicas, n_shards >= 1, got "
                         f"{n_replicas}, {n_shards}")
    dev = resolve_device(device)
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    return [[devs[(r * n_shards + s) % len(devs)] for s in range(n_shards)]
            for r in range(n_replicas)]


def _n_parts(inner) -> int:
    return len(inner.shards) if isinstance(inner, ShardedIndex) else 1


class ReplicatedIndex:
    """Replica groups behind one index API: ``search_batch`` (the parity
    surface) routes to replica 0, ``search_batch_on(r, ...)`` is the
    router's per-lane entry."""

    def __init__(self, replicas: Sequence, *, own_inner: bool = False,
                 device_table: Optional[List[List]] = None,
                 use_shard_map: Optional[bool] = None):
        if use_shard_map:
            raise NotImplementedError(
                "ReplicatedIndex(use_shard_map=True): the SPMD flat plan "
                "is a shard_map program over a device mesh and waits for "
                "sharding/* (ROADMAP queue 1, item 8)")
        self._inners = list(replicas)
        if not self._inners:
            raise ValueError("need at least one replica")
        first = self._inners[0]
        for ix in self._inners[1:]:
            if ix.backend != first.backend or ix.n_docs != first.n_docs:
                raise ValueError("replicas differ in backend or corpus")
        self.n_replicas = len(self._inners)
        self.own_inner = own_inner
        self._distinct = (len({id(ix) for ix in self._inners})
                          == self.n_replicas)
        self.device_table = (
            [[torch.device(d) for d in row] for row in device_table]
            if device_table is not None
            else serve_device_table(self.n_replicas, max(_n_parts(first), 1),
                                    first.device))
        if len(self.device_table) != self.n_replicas:
            raise ValueError(f"{len(self.device_table)} device rows for "
                             f"{self.n_replicas} replicas")
        self._multi_device = len({d for row in self.device_table
                                  for d in row}) > 1
        self._closed = False
        self._place_all()

    # -------------------------------------------------------- construction
    @classmethod
    def replicate(cls, index, n_replicas: int = 1, own_inner: bool = False,
                  **kw) -> "ReplicatedIndex":
        """Replica groups over ONE shared inner index (no copies)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        return cls([index] * int(n_replicas), own_inner=own_inner, **kw)

    @classmethod
    def from_dir(cls, path: str, n_replicas: int = 1, mmap: bool = True,
                 device: DeviceLike = None, **kw) -> "ReplicatedIndex":
        """One reopen of the artifact per replica group, each onto its
        group's first device. The auto probe-thread width of a sharded
        artifact is divided across the groups, so lanes x workers never
        oversubscribe; a ``probe_threads`` pin in the manifest is kept."""
        from repro_torch.core.persist import load_artifact, read_manifest
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        manifest = read_manifest(path)
        n_shards = max(len(manifest.get("shards", [])), 1)
        table = kw.pop("device_table", None) or serve_device_table(
            int(n_replicas), n_shards, device)
        reps = []
        for r in range(int(n_replicas)):
            ix = load_artifact(path, mmap=mmap, device=table[r][0])
            if (isinstance(ix, ShardedIndex) and n_replicas > 1
                    and ix.probe_threads_cfg == 0):
                ix.set_probe_threads(
                    max(1, ix.probe_threads // int(n_replicas)))
            reps.append(ix)
        return cls(reps, own_inner=True, device_table=table, **kw)

    def _place_all(self) -> None:
        if not self._multi_device:
            return                      # one device: placement is moot
        placed = set()
        for r, inner in enumerate(self._inners):
            if id(inner) in placed:
                continue                # shared inner: group 0's row wins
            placed.add(id(inner))
            if isinstance(inner, ShardedIndex):
                row = self.device_table[r]
                inner.place([row[i % len(row)]
                             for i in range(inner.n_shards)])

    # ------------------------------------------------------------- topology
    @property
    def inner(self):
        return self._inners[0]

    @property
    def backend(self) -> str:
        return self._inners[0].backend

    @property
    def dim(self) -> int:
        return self._inners[0].dim

    @property
    def device(self) -> torch.device:
        return self._inners[0].device

    @property
    def n_docs(self) -> int:
        return self._inners[0].n_docs

    @property
    def n_shards(self) -> int:
        return _n_parts(self._inners[0])

    def n_vectors(self) -> int:
        return self._inners[0].n_vectors()

    def nbytes(self) -> int:
        return self._inners[0].nbytes()

    def device_bytes(self) -> int:
        seen, total = set(), 0
        for ix in self._inners:
            if id(ix) not in seen:
                seen.add(id(ix))
                total += ix.device_bytes()
        return total

    def _distinct_inners(self):
        seen = set()
        for ix in self._inners:
            if id(ix) not in seen:
                seen.add(id(ix))
                yield ix

    # ----------------------------------------------------------------- CRUD
    def add(self, doc_vectors):
        if self._distinct and self.n_replicas > 1:
            raise RuntimeError(
                "add() on a multi-copy ReplicatedIndex would desync the "
                "replicas — rebuild the artifact and hot-swap instead")
        return self._inners[0].add(doc_vectors)

    def delete(self, doc_ids) -> None:
        for ix in self._distinct_inners():
            ix.delete(doc_ids)

    def set_probe_kernel(self, probe_kernel: str) -> None:
        """Fan the runtime-only plaid candidate path to every distinct
        inner (monolithic or sharded)."""
        from repro_torch.core.plaid import PROBE_KERNELS
        if probe_kernel not in PROBE_KERNELS:
            raise ValueError(f"probe_kernel must be one of {PROBE_KERNELS}, "
                             f"got {probe_kernel!r}")
        for ix in self._distinct_inners():
            if isinstance(ix, ShardedIndex):
                ix.set_probe_kernel(probe_kernel)
            else:
                ix.probe_kernel = probe_kernel

    # ---------------------------------------------------------------- search
    def search_batch_on(self, replica: int, qs, k: int = 10,
                        q_mask: Optional[torch.Tensor] = None,
                        impl: str = "auto"):
        """One replica lane's search; every lane gives the same result."""
        inner = self._inners[int(replica) % self.n_replicas]
        return inner.search_batch(qs, k=k, q_mask=q_mask, impl=impl)

    def search_batch(self, qs, k: int = 10,
                     q_mask: Optional[torch.Tensor] = None,
                     impl: str = "auto"):
        """Parity surface: the wrapped index's ``search_batch`` (lane 0)."""
        return self.search_batch_on(0, qs, k=k, q_mask=q_mask, impl=impl)

    def search(self, q, k: int = 10):
        S, I = self.search_batch(torch.as_tensor(q)[None], k=k)
        valid = I[0] >= 0
        return S[0][valid], I[0][valid]

    def warm_shapes(self, qs, k: int = 10) -> None:
        """Search once on every distinct inner at this batch shape, so
        each copy's lazy device views are built before traffic."""
        for ix in self._distinct_inners():
            ix.search_batch(qs, k=k)

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release every distinct inner's resources (``own_inner`` only:
        watcher loads and ``from_dir``) — the hot-swap retire hook."""
        if self._closed:
            return
        self._closed = True
        if not self.own_inner:
            return
        for ix in self._distinct_inners():
            close = getattr(ix, "close", None)
            if close is not None:
                close()

    @property
    def closed(self) -> bool:
        return self._closed

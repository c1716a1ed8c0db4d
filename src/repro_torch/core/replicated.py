"""ReplicatedIndex: one logical index served as ``n_replicas`` replica
groups, each a search lane of the serving engine (counterpart of
``src/repro/core/replicated.py``).

Replicas may share ONE inner index object (``replicate``: no extra host
or device memory) or hold distinct copies (``from_dir``: one reopen of
the artifact a group, each loaded onto its group's device). Every lane
returns the same results as the wrapped index's ``search_batch`` (ids,
scores and tie order), so the engine's router picks a lane for
throughput only. Placement regimes:

  * **Generic dispatch** (any backend): ``launch/mesh.serve_device_table``
    tiles the (replica, shard) cells over ``cuda:0 .. cuda:n-1``
    round-robin; a sharded inner's shards probe under their row's devices
    (``ShardedIndex.place``) and merge their [Nq, k] blocks.
  * **SPMD flat scan** (flat backend, one device a live shard): a
    group's dense scan is one plan over its device row (``_FlatPlan``):
    each live shard, padded to the group's doc and token counts, sits on
    its own device (the ``serve_rules`` "docs" axis over the row's
    ("shard",) grid); each device scores the queries with the ``maxsim``
    kernel on its own stream, masks dead docs, takes its top-k and
    shifts it to global ids; the blocks are gathered to the first device
    in shard order and one ``topk_with_pads`` merges them. The reference
    runs this as one ``shard_map`` program with an ``all_gather``; the
    PyTorch form is one process over the row, since the index lives in
    the engine's process. Shard order is the gather order, so the
    dispatch merge's tie order carries over.
  * **Degraded single device**: fewer devices than cells. Everything
    serves through the dispatch; on one card every group lands on
    ``cuda:0``, with lane concurrency only. A forced plan there
    (``use_shard_map=True``) is built only for a group with one live
    part (a monolithic flat index, a one-cell plan); a sharded group's
    row reuses the card, so it falls back to the dispatch merge, as the
    reference's does.

Mutation is a serving anti-pattern here: ``delete`` fans to every copy
and drops the plans; ``add`` requires the shared-inner form (it drops
the plans too) — rebuild and hot-swap is the supported path for growth.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.maxsim import (maxsim_all_docs, topk_shard,
                                     topk_with_pads)
from repro_torch.core.sharded import ShardedIndex
from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import (distinct_row, make_shard_mesh,
                                     serve_device_table)


def _parts(inner) -> List[Tuple[int, object]]:
    """(global doc base, shard) pairs — a monolithic index is one part."""
    if isinstance(inner, ShardedIndex):
        return list(zip(inner.doc_base, inner.shards))
    return [(0, inner)]


def _n_parts(inner) -> int:
    return len(_parts(inner))


def _padded_to(t: torch.Tensor, shape, dev: torch.device) -> torch.Tensor:
    """``t`` zero-padded to ``shape`` on ``dev`` (``t`` itself when it is
    that already)."""
    if tuple(t.shape) == tuple(shape) and t.device == dev:
        return t
    out = torch.zeros(shape, dtype=t.dtype, device=dev)
    out[tuple(slice(0, n) for n in t.shape)] = t.to(dev)
    return out


class _FlatPlan:
    """One replica group's flat corpus scan over its device row.

    Each live part's store view (``padded()``: [n, L, dim], [n, L]) and
    live mask are padded to the group's largest n and L (MaxSim is
    pad-invariant: a masked token scores -inf into a max, a padded doc
    row is live-masked to -inf) and placed on its device of the row's
    ("shard",) grid (``serve_rules``' "docs" axis). ``search``
    runs each part's ``maxsim_all_docs``, live mask and top-k on its
    device (its own stream on a card), then gathers the [Nq, kk] blocks
    to the merge device in shard order for one ``topk_with_pads``: the
    dispatch merge's arithmetic, one scan a device."""

    def __init__(self, parts: Sequence[Tuple[int, object]], row: Sequence):
        devices = make_shard_mesh(row).devices
        if len(parts) != len(devices):
            raise ValueError(f"{len(parts)} parts over a row of "
                             f"{len(devices)} devices")
        views = [(base, *shard.store.padded(), shard._live())
                 for base, shard in parts]
        Ndp = max(v[1].shape[0] for v in views)
        Lp = max(v[1].shape[1] for v in views)
        dim = views[0][1].shape[2]
        self.merge_device = devices[0]
        self.n_docs_padded = Ndp
        self.cells = []
        for dev, (base, d, m, live) in zip(devices, views):
            lv = torch.zeros(Ndp, dtype=torch.bool)
            lv[:len(live)] = torch.from_numpy(np.asarray(live, bool))
            stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)
            self.cells.append((dev, stream,
                               _padded_to(d, (Ndp, Lp, dim), dev),
                               _padded_to(m, (Ndp, Lp), dev),
                               lv.to(dev), int(base)))

    def search(self, qs, q_mask, k: int, impl: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
        qs = torch.as_tensor(qs).float()
        qm = (torch.ones(qs.shape[:2], dtype=torch.bool, device=qs.device)
              if q_mask is None else torch.as_tensor(q_mask).bool())
        kk = min(k, self.n_docs_padded)
        blocks, events = [], []
        for dev, stream, d, m, lv, base in self.cells:
            if stream is None:
                blocks.append(self._scan(dev, qs, qm, d, m, lv, base, kk,
                                         impl))
                continue
            if qs.device.type == "cuda":    # after the queries' producers
                stream.wait_stream(torch.cuda.current_stream(qs.device))
            with torch.cuda.stream(stream):
                blocks.append(self._scan(dev, qs, qm, d, m, lv, base, kk,
                                         impl))
                events.append(stream.record_event())
        md = self.merge_device
        for event in events:
            torch.cuda.current_stream(md).wait_event(event)
        top_s = torch.cat([b[0].to(md) for b in blocks], dim=1)
        top_i = torch.cat([b[1].to(md) for b in blocks], dim=1)
        return topk_with_pads(top_s, top_i, k)

    @staticmethod
    def _scan(dev, qs, qm, d, m, lv, base, kk, impl):
        s = maxsim_all_docs(qs.to(dev), qm.to(dev), d, m, impl=impl)
        s = s.masked_fill(~lv[None, :], float("-inf"))
        return topk_shard(s, None, kk, base)


class ReplicatedIndex:
    """Replica groups behind one index API: ``search_batch`` (the parity
    surface) routes to replica 0, ``search_batch_on(r, ...)`` is the
    router's per-lane entry."""

    def __init__(self, replicas: Sequence, *, own_inner: bool = False,
                 device_table: Optional[List[List]] = None,
                 use_shard_map: Optional[bool] = None):
        self._inners = list(replicas)
        if not self._inners:
            raise ValueError("need at least one replica")
        first = self._inners[0]
        for ix in self._inners[1:]:
            if ix.backend != first.backend or ix.n_docs != first.n_docs:
                raise ValueError("replicas differ in backend or corpus")
        self.n_replicas = len(self._inners)
        self.own_inner = own_inner
        # None = auto (flat backend, >= 2 live shards, one device each);
        # False = dispatch only; True = a plan wherever one is buildable
        self.use_shard_map = use_shard_map
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
        self._plans: Dict[int, Optional[_FlatPlan]] = {}
        self._plan_lock = threading.Lock()
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
    def _invalidate(self) -> None:
        with self._plan_lock:
            self._plans.clear()

    def add(self, doc_vectors):
        if self._distinct and self.n_replicas > 1:
            raise RuntimeError(
                "add() on a multi-copy ReplicatedIndex would desync the "
                "replicas — rebuild the artifact and hot-swap instead")
        ids = self._inners[0].add(doc_vectors)
        self._invalidate()
        return ids

    def delete(self, doc_ids) -> None:
        for ix in self._distinct_inners():
            ix.delete(doc_ids)
        self._invalidate()

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

    # ----------------------------------------------------------------- plans
    def _plan_for(self, r: int) -> Optional[_FlatPlan]:
        """Replica ``r``'s flat plan, built on first use: flat backend
        only; never with ``use_shard_map=False``; auto needs at least two
        live parts on more than one device; any plan needs a row of
        distinct devices (``distinct_row``). None: the dispatch serves."""
        if self.backend != "flat" or self.use_shard_map is False:
            return None
        with self._plan_lock:
            if r in self._plans:
                return self._plans[r]
            every = _parts(self._inners[r])
            pos = [i for i, (_, shard) in enumerate(every)
                   if shard.n_docs > 0]
            # modulo-tile: adds can grow the shard count past the table
            tbl = self.device_table[r]
            row = [tbl[i % len(tbl)] for i in pos]
            auto_ok = len(pos) >= 2 and self._multi_device
            ok = (bool(pos) and distinct_row(row)
                  and (auto_ok or self.use_shard_map is True))
            plan = _FlatPlan([every[i] for i in pos], row) if ok else None
            self._plans[r] = plan
            return plan

    # ---------------------------------------------------------------- search
    def search_batch_on(self, replica: int, qs, k: int = 10,
                        q_mask: Optional[torch.Tensor] = None,
                        impl: str = "auto"):
        """One replica lane's search; every lane gives the same result."""
        r = int(replica) % self.n_replicas
        plan = self._plan_for(r)
        if plan is not None:
            return plan.search(qs, q_mask, k, impl)
        return self._inners[r].search_batch(qs, k=k, q_mask=q_mask,
                                            impl=impl)

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
        """Search once on every lane with a plan (building it) and once
        on every other distinct inner, so each copy's lazy device views
        are built before traffic."""
        warmed = set()
        for r in range(self.n_replicas):
            plan = self._plan_for(r)
            if plan is not None:
                plan.search(qs, None, k)
                continue
            inner = self._inners[r]
            if id(inner) not in warmed:
                warmed.add(id(inner))
                inner.search_batch(qs, k=k)

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Drop the plans and release every distinct inner's resources
        (``own_inner`` only: watcher loads and ``from_dir``) — the
        hot-swap retire hook."""
        if self._closed:
            return
        self._closed = True
        self._invalidate()
        if not self.own_inner:
            return
        for ix in self._distinct_inners():
            close = getattr(ix, "close", None)
            if close is not None:
                close()

    @property
    def closed(self) -> bool:
        return self._closed

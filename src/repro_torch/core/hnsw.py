"""Hierarchical Navigable Small World index (Malkov & Yashunin, 2018).

A copy of ``src/repro/core/hnsw.py`` (the port imports nothing of the
JAX package). The paper's unquantized experiments use the VOYAGER HNSW
library with M=12, ef_construction=200. The graph walk is latency-bound
pointer chasing and stays host numpy; the card runs the encode, the
pooling and the stage-2 rerank. The level draws (``default_rng(seed)``)
and the float32 dot products are the reference's, so the same vectors
build the same graph in both packages.

Supports incremental ``add`` and lazy ``delete``.
"""
from __future__ import annotations

import heapq
import math
from typing import List, Optional

import numpy as np


class HNSW:
    def __init__(self, dim: int, m: int = 12, ef_construction: int = 200,
                 seed: int = 0):
        self.dim = dim
        self.m = m
        self.m0 = 2 * m
        self.ef_construction = ef_construction
        self.ml = 1.0 / math.log(m)
        self.rng = np.random.default_rng(seed)
        self.vectors = np.zeros((0, dim), np.float32)
        self.levels: List[int] = []
        self.graph: List[List[dict]] = []      # graph[lvl][node] -> list[int]
        self.entry: Optional[int] = None
        self.max_level = -1
        self.deleted: set = set()

    @classmethod
    def from_state(cls, dim: int, m: int, ef_construction: int,
                   vectors: np.ndarray, levels: np.ndarray,
                   edge_counts: np.ndarray, edges: np.ndarray,
                   deleted: np.ndarray, entry: int, max_level: int,
                   seed: int = 0) -> "HNSW":
        """Rebuild from persisted CSR graph state (core/persist.py).

        ``vectors`` may be a read-only memmap (search only reads it;
        ``add`` concatenates into a fresh array). The rng restarts from
        ``seed``, so level draws of post-load inserts are independent
        of the saved instance's draw history — search over the saved
        graph is unaffected.
        """
        self = cls(dim, m=m, ef_construction=ef_construction, seed=seed)
        self.vectors = np.asarray(vectors, np.float32)
        self.levels = [int(x) for x in levels]
        n = len(self.levels)
        bounds = np.zeros(edge_counts.size + 1, np.int64)
        np.cumsum(np.asarray(edge_counts).ravel(), out=bounds[1:])
        edges = np.asarray(edges, np.int64)
        self.graph = [
            [edges[bounds[lv * n + i]:bounds[lv * n + i + 1]].tolist()
             for i in range(n)]
            for lv in range(edge_counts.shape[0])]
        self.entry = None if entry < 0 else int(entry)
        self.max_level = int(max_level)
        self.deleted = set(int(i) for i in np.asarray(deleted))
        return self

    # -- distances: inner product on unit vectors (cosine) ------------------
    def _sims(self, q, ids):
        return self.vectors[ids] @ q

    def _search_layer(self, q, entry_points, ef, lvl):
        visited = set(entry_points)
        cand = []      # max-heap by sim (store -sim)
        best = []      # min-heap of (sim, id), size <= ef
        for p in entry_points:
            s = float(self.vectors[p] @ q)
            heapq.heappush(cand, (-s, p))
            heapq.heappush(best, (s, p))
        while cand:
            cs, c = heapq.heappop(cand)
            if -cs < best[0][0] and len(best) >= ef:
                break
            for nb in self.graph[lvl][c]:
                if nb in visited:
                    continue
                visited.add(nb)
                s = float(self.vectors[nb] @ q)
                if len(best) < ef or s > best[0][0]:
                    heapq.heappush(cand, (-s, nb))
                    heapq.heappush(best, (s, nb))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted(best, reverse=True)      # [(sim, id)] best first

    def _select_neighbors(self, q, candidates, m):
        """Simple heuristic: top-m by similarity."""
        return [i for _, i in sorted(candidates, reverse=True)[:m]]

    def add(self, vecs: np.ndarray) -> np.ndarray:
        """Insert vectors; returns assigned ids."""
        vecs = np.asarray(vecs, np.float32)
        n0 = self.vectors.shape[0]
        ids = np.arange(n0, n0 + len(vecs))
        self.vectors = np.concatenate([self.vectors, vecs], axis=0)
        for vid, v in zip(ids, vecs):
            self._insert(int(vid), v)
        return ids

    def _insert(self, vid: int, v: np.ndarray):
        lvl = int(-math.log(max(self.rng.random(), 1e-12)) * self.ml)
        self.levels.append(lvl)
        while self.max_level < lvl:
            self.max_level += 1
            self.graph.append([])
        # ensure adjacency rows exist on every level
        for l in range(self.max_level + 1):
            while len(self.graph[l]) <= vid:
                self.graph[l].append([])
        if self.entry is None:
            self.entry = vid
            return
        ep = [self.entry]
        for l in range(self.max_level, lvl, -1):
            res = self._search_layer(v, ep, 1, l)
            if res:
                ep = [res[0][1]]
        for l in range(min(lvl, self.max_level), -1, -1):
            cand = self._search_layer(v, ep, self.ef_construction, l)
            m = self.m0 if l == 0 else self.m
            neigh = self._select_neighbors(v, cand, m)
            self.graph[l][vid] = list(neigh)
            for nb in neigh:
                lst = self.graph[l][nb]
                lst.append(vid)
                if len(lst) > m:
                    sims = self.vectors[lst] @ self.vectors[nb]
                    keep = np.argsort(-sims)[:m]
                    self.graph[l][nb] = [lst[i] for i in keep]
            ep = [i for _, i in cand] or ep
        if self.levels[vid] > self.levels[self.entry]:
            self.entry = vid

    def delete(self, ids):
        """Lazy delete: results filter; graph edges retained as routing."""
        self.deleted.update(int(i) for i in ids)

    def search(self, q: np.ndarray, k: int, ef: Optional[int] = None):
        """q: [dim] -> (sims [k'], ids [k'])."""
        if self.entry is None:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        ef = ef or max(4 * k, 64)
        ep = [self.entry]
        for l in range(self.max_level, 0, -1):
            res = self._search_layer(q, ep, 1, l)
            if res:
                ep = [res[0][1]]
        res = self._search_layer(q, ep, max(ef, k), 0)
        res = [(s, i) for s, i in res if i not in self.deleted][:k]
        if not res:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        sims, ids = zip(*res)
        return np.asarray(sims, np.float32), np.asarray(ids, np.int64)

    def search_batch(self, qs: np.ndarray, k: int, ef: Optional[int] = None):
        sims, ids = [], []
        for q in qs:
            s, i = self.search(q, k, ef)
            # pad to k
            if len(i) < k:
                s = np.pad(s, (0, k - len(s)), constant_values=-np.inf)
                i = np.pad(i, (0, k - len(i)), constant_values=-1)
            sims.append(s)
            ids.append(i)
        return np.stack(sims), np.stack(ids)

    def probe_tokens(self, qs: np.ndarray, k: int,
                     ef: Optional[int] = None) -> np.ndarray:
        """Batched token probe: qs [T, dim] -> vector ids [T, k] (-1 pad).

        The graph walk itself is inherently sequential per token
        (latency-bound pointer chasing); this batches the
        bookkeeping so callers get one fixed-shape id matrix for the
        whole query batch and never touch per-token Python results.
        """
        out = np.full((len(qs), k), -1, np.int64)
        for t, q in enumerate(np.asarray(qs, np.float32)):
            _, ids = self.search(q, k, ef)
            out[t, :len(ids)] = ids
        return out

    def nbytes(self) -> int:
        vec = self.vectors.size * 2                     # stored fp16
        edges = sum(len(r) for lvl in self.graph for r in lvl) * 4
        return vec + edges

"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg`` cell
(``src/repro/models/gnn/sampler.py``, copied: host numpy, the same
``default_rng(seed)`` draws, so one seed gives the reference's nodes,
edges and masks).

Host-side: samples a fixed-fanout k-hop subgraph around a seed batch from
a CSR adjacency, emitting FIXED-SHAPE padded node / edge tensors, so
every step has the same shapes.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class NeighborSampler:
    def __init__(self, edge_index: np.ndarray, n_nodes: int,
                 fanouts: Sequence[int], seed: int = 0):
        """edge_index: [2, E] (src, dst) — sampling walks dst -> src."""
        src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order].astype(np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self.n_nodes = n_nodes
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def node_budget(self, batch_nodes: int) -> int:
        n = batch_nodes
        total = n
        for f in self.fanouts:
            n = n * f
            total += n
        return total

    def edge_budget(self, batch_nodes: int) -> int:
        n = batch_nodes
        total = 0
        for f in self.fanouts:
            total += n * f
            n = n * f
        return total

    def sample(self, seeds: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (nodes [n_budget], edge_index [2, e_budget],
        node_mask, edge_mask). ``nodes`` are ORIGINAL graph ids; edges use
        LOCAL (subgraph) indices. Padded entries masked False.
        """
        seeds = np.asarray(seeds, np.int64)
        B = len(seeds)
        n_budget = self.node_budget(B)
        e_budget = self.edge_budget(B)
        nodes = np.zeros(n_budget, np.int64)
        node_mask = np.zeros(n_budget, bool)
        nodes[:B] = seeds
        node_mask[:B] = True
        e_src = np.zeros(e_budget, np.int32)
        e_dst = np.zeros(e_budget, np.int32)
        e_mask = np.zeros(e_budget, bool)

        frontier_lo, frontier_hi = 0, B   # local index range of current layer
        n_ptr, e_ptr = B, 0
        for f in self.fanouts:
            layer = np.arange(frontier_lo, frontier_hi)
            for local in layer:
                if not node_mask[local]:
                    n_ptr += f
                    e_ptr += f
                    continue
                g = nodes[local]
                lo, hi = self.offsets[g], self.offsets[g + 1]
                deg = hi - lo
                if deg > 0:
                    pick = self.rng.integers(lo, hi, size=f)
                    nb = self.nbr[pick]
                    k = f
                    nodes[n_ptr:n_ptr + k] = nb
                    node_mask[n_ptr:n_ptr + k] = True
                    e_src[e_ptr:e_ptr + k] = np.arange(n_ptr, n_ptr + k)
                    e_dst[e_ptr:e_ptr + k] = local
                    e_mask[e_ptr:e_ptr + k] = True
                n_ptr += f
                e_ptr += f
            frontier_lo, frontier_hi = frontier_hi, n_ptr
        return nodes, np.stack([e_src, e_dst]), node_mask, e_mask

"""IVF coarse quantizer: centroid training and inverted lists.

Counterparts of ``src/repro/core/ivf.py``: ``InvertedLists`` (CSR,
host numpy), ``DeviceInvertedLists`` and its host-side build (shipped
to the device once), ``train_centroids``, ``assign_vectors`` and
``build_inverted_lists``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.docstore import ragged_arange
from repro_torch.core.kmeans import kmeans_train


@dataclass
class InvertedLists:
    """CSR: vectors of centroid c are ids[offsets[c]:offsets[c+1]]."""
    offsets: np.ndarray          # [K + 1] int64
    ids: np.ndarray              # [n_vectors] int64, centroid-major

    @property
    def n_centroids(self) -> int:
        return len(self.offsets) - 1

    def list_for(self, c: int) -> np.ndarray:
        return self.ids[self.offsets[c]:self.offsets[c + 1]]

    def lists_for(self, cs) -> np.ndarray:
        """Sorted unique vector ids of several centroids' lists, in one
        gather (the sweep ``plaid._gather_candidates`` runs)."""
        cs = np.unique(np.asarray(cs, np.int64))
        starts = self.offsets[cs]
        lens = self.offsets[cs + 1] - starts
        if int(lens.sum()) == 0:
            return np.zeros((0,), np.int64)
        pos = np.repeat(starts, lens) + ragged_arange(lens)
        return np.unique(self.ids[pos])


@dataclass
class DeviceInvertedLists:
    """Device-resident IVF views for the candidate path:

      * ``offsets``/``ids``: the CSR itself;
      * ``doc_lists`` [K, Lmax] int32: each centroid's unique owner docs
        ascending, padded with the sentinel ``n_docs`` (``doc_valid``
        marks real entries);
      * ``doc_member`` [K, n_docs] f32 0/1: the same entries densely — a
        probed-centroid row times this table counts how many probed
        lists own each doc.

    ``list_cap`` bounds Lmax: a longer list keeps its lowest doc ids and
    the dropped entries are counted in ``overflow``. Only an exact view
    (``overflow == 0``) serves the device candidate path.
    """
    offsets: torch.Tensor
    ids: torch.Tensor
    doc_lists: torch.Tensor
    doc_valid: torch.Tensor
    doc_member: torch.Tensor
    list_cap: int                # Lmax actually used
    overflow: int                # entries dropped by the cap (0: exact)
    n_docs: int = 0

    @property
    def n_centroids(self) -> int:
        return self.doc_lists.shape[0]

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.offsets, self.ids, self.doc_lists,
                             self.doc_valid, self.doc_member))


def build_device_inverted_lists(ivf: InvertedLists, vec2doc: np.ndarray,
                                n_docs: int, list_cap: int = 0, *,
                                device: torch.device
                                ) -> DeviceInvertedLists:
    """Host-side build, then one copy to ``device``. ``list_cap=0``
    sizes Lmax to the longest unique-doc list (exact); a positive cap
    keeps each list's lowest doc ids and counts the drops in
    ``overflow``."""
    K = ivf.n_centroids
    lens = np.diff(ivf.offsets)
    cent = np.repeat(np.arange(K, dtype=np.int64), lens)
    docs = np.asarray(vec2doc, np.int64)[ivf.ids]
    nd = max(n_docs, 1)
    cd = np.unique(cent * np.int64(nd) + docs)
    ci, di = cd // nd, cd % nd
    counts = np.bincount(ci, minlength=K)
    full = int(counts.max(initial=0))
    cap = max(full if list_cap <= 0 else min(int(list_cap), full), 1)
    kept = np.minimum(counts, cap)
    group_starts = np.zeros(K, np.int64)
    np.cumsum(counts[:-1], out=group_starts[1:])
    pos = np.repeat(group_starts, kept) + ragged_arange(kept)
    doc_lists = np.full((K, cap), n_docs, np.int32)
    doc_valid = np.zeros((K, cap), bool)
    rows = np.repeat(np.arange(K), kept)
    cols = ragged_arange(kept)
    doc_lists[rows, cols] = di[pos]
    doc_valid[rows, cols] = True
    doc_member = np.zeros((K, nd), np.float32)
    doc_member[rows, di[pos]] = 1.0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceInvertedLists(
        offsets=dev(ivf.offsets.astype(np.int32)),
        ids=dev(ivf.ids.astype(np.int32)),
        doc_lists=dev(doc_lists), doc_valid=dev(doc_valid),
        doc_member=dev(doc_member), list_cap=cap,
        overflow=int((counts - kept).sum()), n_docs=int(n_docs))


def train_centroids(vectors: torch.Tensor, n_centroids: int,
                    n_iters: int = 12, *, seed: int = 0,
                    init_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """vectors [M, dim] -> unit centroids [K, dim] (cosine k-means)."""
    return kmeans_train(vectors, n_centroids, n_iters, init_idx=init_idx,
                        seed=seed)


def assign_vectors(vectors: torch.Tensor,
                   centroids: torch.Tensor) -> np.ndarray:
    """Nearest (max cosine) centroid per vector -> host [M] int32 (ties
    to the lowest centroid id)."""
    v = torch.as_tensor(vectors).float()
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-9)
    c = torch.as_tensor(centroids, device=v.device).float()
    return torch.argmax(v @ c.T, dim=-1).to(torch.int32).cpu().numpy()


def build_inverted_lists(assign: np.ndarray, n_centroids: int
                         ) -> InvertedLists:
    assign = np.asarray(assign)
    order = np.argsort(assign, kind="stable").astype(np.int64)
    counts = np.bincount(assign, minlength=n_centroids)
    offsets = np.zeros(n_centroids + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return InvertedLists(offsets=offsets, ids=order)

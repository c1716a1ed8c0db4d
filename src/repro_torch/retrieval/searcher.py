"""Searcher: query encode -> staged candidate generation -> rerank.

Counterpart of ``src/repro/retrieval/searcher.py``: ``encode_queries``
encodes chunks of up to ``encode_batch`` queries, each padded to the
full ``encode_batch`` width (the reference pads to the nearest power of
two): on the card cuBLAS picks its bf16 GEMM by the number of rows, and
a query encoded in a batch of 2 and in one of 32 differs by up to ~3e-3
a coordinate, which moves its candidate set; at one width its vector is
the same whichever queries share the batch, so a serving engine's
coalesced batches return a direct search's results. ``search_encoded``
runs the index's batched
two-stage engine; ``search`` (alias ``search_batch``) chains the two;
``rankings`` gives each query's ranked ids; ``from_dir`` serves a saved
artifact (written by either package): a flat, hnsw or plaid
``MultiVectorIndex``, a ``ShardedIndex`` or a ``CascadeIndex``.
``warmup`` encodes each batch size once and calls the index's
``warm_shapes`` (a no-op: PyTorch does not trace per shape). Query time
is unchanged by token pooling — the searcher is the same for pooled and
unpooled indexes.
"""
from __future__ import annotations

import warnings
from typing import Iterable, List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.index import MultiVectorIndex
from repro_torch.device import DeviceLike
from repro_torch.models.colbert import ColBERT, encode_queries
from repro_torch.core.sharded import ShardedIndex
from repro_torch.retrieval.cascade import CascadeIndex


class Searcher:
    def __init__(self, model: ColBERT,
                 index: Union[MultiVectorIndex, ShardedIndex, CascadeIndex],
                 encode_batch: int = 64):
        if index is not None and model.device.type != torch.device(
                index.device).type:
            raise ValueError(f"model is on {model.device}, index on "
                             f"{index.device}")
        self.model = model
        self.cfg = model.cfg
        self.index = index
        self.encode_batch = int(encode_batch)

    @classmethod
    def from_dir(cls, model: ColBERT, path: str, device: DeviceLike = None,
                 mmap: bool = True, encode_batch: int = 64) -> "Searcher":
        """Serve the index, sharded index or cascade artifact at
        ``path`` (no corpus encode, no build), loaded onto ``device``
        (``cuda`` when not given); dispatches on the manifest ``kind``."""
        from repro_torch.core.persist import load_artifact
        return cls(model, load_artifact(path, mmap=mmap, device=device),
                   encode_batch=encode_batch)

    def encode_queries(self, query_tokens: np.ndarray) -> torch.Tensor:
        """[Nq, L] raw ids -> [Nq, Lq, dim] on the model's device."""
        query_tokens = np.asarray(query_tokens)
        out = []
        for lo in range(0, query_tokens.shape[0], self.encode_batch):
            chunk = query_tokens[lo:lo + self.encode_batch]
            n = chunk.shape[0]
            pad = self.encode_batch - n
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            v, _ = encode_queries(self.model, chunk)
            out.append(v[:n])
        return torch.cat(out)

    def encode(self, query_tokens: np.ndarray) -> torch.Tensor:
        """Deprecated alias of ``encode_queries``."""
        warnings.warn("Searcher.encode is deprecated; use "
                      "Searcher.encode_queries", DeprecationWarning,
                      stacklevel=2)
        return self.encode_queries(query_tokens)

    def search(self, query_tokens: np.ndarray, k: int = 10,
               impl: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """[Nq, L] raw ids -> host (scores [Nq, k], doc ids [Nq, k])."""
        return self.search_encoded(self.encode_queries(query_tokens), k=k,
                                   impl=impl)

    def search_encoded(self, query_vectors: torch.Tensor, k: int = 10,
                       impl: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Pre-encoded [Nq, Lq, dim] -> (scores [Nq, k], ids [Nq, k])."""
        return self.index.search_batch(query_vectors, k=k, impl=impl)

    # a Searcher search is always batched
    search_batch = search

    def rankings(self, query_tokens: np.ndarray, k: int = 10
                 ) -> List[List[int]]:
        """Each query's ranked doc ids (pads dropped)."""
        _, ids = self.search(query_tokens, k)
        return [[int(d) for d in row if d >= 0] for row in ids]

    def warmup(self, batch_sizes: Union[int, Iterable[int]],
               k: int = 10) -> None:
        """Encode a batch of each size once (the encoder's first calls
        at that width) and call the index's ``warm_shapes`` where it has
        one, else search once."""
        if isinstance(batch_sizes, (int, np.integer)):
            batch_sizes = [int(batch_sizes)]
        sizes = sorted({int(b) for b in batch_sizes})
        L = self.cfg.query_maxlen - 2
        warm = getattr(self.index, "warm_shapes", None)
        for bs in sizes:
            enc = self.encode_queries(np.ones((bs, L), np.int32))
            if warm is not None:
                warm(enc, k=k)
            else:
                self.search_encoded(enc, k=k)

"""Indexer: encode -> TOKEN POOL -> index, the paper's pipeline.

Counterpart of ``src/repro/retrieval/indexer.py`` ``Indexer.build``
(streaming builds are queued in ROADMAP queue 1):

  1. encode documents in batches of ``encode_batch`` with the ColBERT
     encoder (the last batch zero-padded to full width),
  2. pool each batch (``PoolingSpec``; Ward through the ``ward_pool``
     kernel) and compact the pooled rows on the device,
  3. build the index (plaid, hnsw or flat) from the compacted rows,
  4. with ``out_dir``, write the artifact (``core/persist.py``) and a
     ``stats.json`` beside its manifest.

Everything stays on the model's device; host work is the IVF
bookkeeping of the build and the artifact write.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.persist import artifact_bytes, serialized_nbytes
from repro_torch.core.pooling import compact_pooled
from repro_torch.core.quantization import ResidualCodec
from repro_torch.core.spec import IndexSpec, PoolingSpec
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models.colbert import ColBERT, encode_docs


@dataclass
class IndexStats:
    n_docs: int
    n_vectors_raw: int
    n_vectors_stored: int
    index_bytes: int = 0     # serialized artifact size (core/persist.py)
    device_bytes: int = 0
    # wall seconds per build stage (host clock around synchronized work)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def vector_reduction(self) -> float:
        if self.n_vectors_raw == 0:
            return 0.0
        return 1.0 - self.n_vectors_stored / self.n_vectors_raw

    def to_json(self) -> dict:
        return dict(dataclasses.asdict(self),
                    vector_reduction=self.vector_reduction)


class Indexer:
    def __init__(self, model: ColBERT, index_spec: Optional[IndexSpec] = None,
                 pooling_spec: Optional[PoolingSpec] = None,
                 encode_batch: int = 64, device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, indexer on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.index_spec = index_spec or IndexSpec.from_config(model.cfg)
        self.pooling = pooling_spec or PoolingSpec(
            method=model.cfg.pool_method, factor=model.cfg.pool_factor)
        self.encode_batch = int(encode_batch)

    def encode_and_pool_counted(self, doc_tokens: np.ndarray,
                                impl: str = "auto",
                                times: Optional[Dict[str, float]] = None
                                ) -> Tuple[torch.Tensor, np.ndarray, int]:
        """doc_tokens [N, L] -> (pooled rows [M, dim] doc-major,
        per-doc counts [N], raw emitted-vector count)."""
        times = {} if times is None else times
        times.setdefault("encode", 0.0)
        times.setdefault("pool", 0.0)
        doc_tokens = np.asarray(doc_tokens)
        N, B = doc_tokens.shape[0], self.encode_batch
        rows, counts, raw = [], [], []
        for lo in range(0, N, B):
            chunk = doc_tokens[lo:lo + B]
            n_real = chunk.shape[0]
            if n_real < B:
                chunk = np.pad(chunk, ((0, B - n_real), (0, 0)))
            t0 = time.perf_counter()
            v, emit = encode_docs(self.model, chunk)
            sync(self.device)
            t1 = time.perf_counter()
            pooled, pmask = self.pooling.apply(v, emit, impl=impl)
            flat, cnt = compact_pooled(pooled[:n_real], pmask[:n_real])
            sync(self.device)
            times["encode"] += t1 - t0
            times["pool"] += time.perf_counter() - t1
            rows.append(flat)
            counts.append(cnt)
            raw.append(emit[:n_real].sum())
        if not rows:
            dim = self.cfg.proj_dim
            return (torch.zeros((0, dim), device=self.device),
                    np.zeros(0, np.int64), 0)
        return (torch.cat(rows), torch.cat(counts).cpu().numpy(),
                int(torch.stack(raw).sum()))

    def encode_and_pool(self, doc_tokens: np.ndarray) -> List[torch.Tensor]:
        """doc_tokens [N, L] -> per-doc pooled vectors ([n_i, dim] views
        on the device), the list form ``build_cascade`` takes."""
        flat, counts, _ = self.encode_and_pool_counted(doc_tokens)
        return list(torch.split(flat, counts.tolist()))

    def build(self, doc_tokens: np.ndarray,
              codec: Optional[ResidualCodec] = None, impl: str = "auto",
              out_dir: Optional[str] = None
              ) -> Tuple[MultiVectorIndex, IndexStats]:
        """doc_tokens [N, L] raw ids -> (MultiVectorIndex, IndexStats).
        ``codec`` presets the plaid residual codec (``set_codec``)
        instead of training one on the pooled vectors. ``out_dir``
        writes the artifact (with the ``pool`` entry) and ``stats.json``;
        ``index_bytes`` is always the serialized size."""
        times: Dict[str, float] = {}
        flat, counts, raw = self.encode_and_pool_counted(doc_tokens, impl,
                                                         times)
        t0 = time.perf_counter()
        index = MultiVectorIndex(dim=self.cfg.proj_dim,
                                 backend=self.index_spec.backend,
                                 device=self.device,
                                 **self.index_spec.params())
        if codec is not None:
            index.set_codec(codec)
        index.add_flat(flat, counts)
        # the search views are built once here, not on the first query
        if index._plaid is not None:
            index._plaid.padded_packed()
            index._plaid.device_ivf()
        elif index._store is not None and index.n_docs:
            index._store.padded()
        sync(self.device)
        times["index"] = time.perf_counter() - t0
        if out_dir is not None:
            t0 = time.perf_counter()
            manifest = index.save(out_dir, extra_meta={
                "pool": self.pooling.manifest_meta()})
            index_bytes = artifact_bytes(manifest)
            times["save"] = time.perf_counter() - t0
        else:
            index_bytes = serialized_nbytes(index)
        stats = IndexStats(n_docs=index.n_docs, n_vectors_raw=raw,
                           n_vectors_stored=index.n_vectors(),
                           index_bytes=index_bytes,
                           device_bytes=index.device_bytes(),
                           stage_seconds=times)
        if out_dir is not None:
            with open(os.path.join(out_dir, "stats.json"), "w") as fh:
                json.dump(stats.to_json(), fh, indent=2)
        return index, stats

"""``QualitySweep`` — the paper's evaluation protocol, grid-wise and
without redundant work (counterpart of ``src/repro/eval/sweep.py``).

  1. the corpus is encoded ONCE (``EncodedDocs`` keeps the encoder's
     outputs on the device with the Indexer's batch boundaries, so each
     pooled index equals the one a re-encode would build);
  2. the unpooled baseline is built ONCE per (backend, quant_bits) and
     shared by every factor-1 cell and every relative value under that
     key;
  3. every cell is built and scored ONLY through the port's
     ``Retriever`` facade, the entry points a user calls.

The port takes the ``ColBERT`` module where the reference takes
``(params, cfg)``, and a ``device`` (``cuda`` unless ``device="cpu"``).
Output is a :class:`~repro_torch.eval.report.QualityReport`.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.eval.datasets import EvalDataset
from repro_torch.eval.metrics import DEFAULT_METRICS, max_k
from repro_torch.eval.report import (QualityBaseline, QualityCell,
                                     QualityReport, baseline_key)

QUANTIZED_BACKENDS = ("plaid",)     # quant_bits sweeps apply here only


def relative_performance(metric: float, baseline: float) -> float:
    """The paper's headline number: 100 = the unpooled baseline.

    The ratio is formed FIRST so ``metric == baseline`` gives exactly
    100.0 (x/x == 1.0 in IEEE for finite nonzero x).
    """
    return 100.0 * (metric / baseline) if baseline > 0 else 0.0


class QualitySweep:
    """Sweep pool_factor x pooling method x backend x quant_bits over
    one dataset, scoring every cell through ``repro_torch.Retriever``.

    Factor-1 cells are the baseline by construction (``PoolingSpec``
    takes factor <= 1 as the identity), so they REUSE the baseline's
    metrics and stats instead of rebuilding: their relative value is
    exactly 100.0.
    """

    def __init__(self, model, dataset: EvalDataset,
                 methods: Sequence[str] = ("ward", "sequential"),
                 factors: Sequence[int] = (1, 2, 3, 4),
                 backends: Sequence[str] = ("flat", "plaid"),
                 quant_bits: Sequence[int] = (2,),
                 metrics: Sequence[str] = DEFAULT_METRICS,
                 k: int = 10,
                 encode_batch: int = 64,
                 index_overrides: Optional[Dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, sweep on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.dataset = dataset
        self.methods = tuple(methods)
        self.factors = tuple(int(f) for f in factors)
        self.backends = tuple(backends)
        self.quant_bits = tuple(int(b) for b in quant_bits)
        self.metrics = tuple(metrics)
        self.k = int(k)
        self.encode_batch = int(encode_batch)
        self.index_overrides = dict(index_overrides or {})
        if not self.methods or not self.factors or not self.backends:
            raise ValueError("methods, factors and backends must each "
                             "be non-empty")

    # ------------------------------------------------------------------
    def _index_spec(self, backend: str, quant_bits: Optional[int]):
        from repro_torch.core.spec import IndexSpec
        over = dict(self.index_overrides)
        if quant_bits is not None:
            over["quant_bits"] = int(quant_bits)
        return IndexSpec.from_config(self.cfg, backend=backend, **over)

    def _build(self, docs, backend: str, quant_bits: Optional[int],
               method: str, factor: int):
        from repro_torch.api import Retriever
        from repro_torch.core.spec import PoolingSpec, RetrieverSpec
        spec = RetrieverSpec(
            pooling=PoolingSpec(method=method if factor > 1 else "none",
                                factor=max(int(factor), 1)),
            index=self._index_spec(backend, quant_bits))
        return Retriever.build(self.model, docs, spec,
                               encode_batch=self.encode_batch,
                               device=self.device)

    def _evaluate(self, retriever) -> Dict[str, float]:
        return retriever.evaluate(self.dataset, metrics=self.metrics,
                                  k=self.k)

    # ------------------------------------------------------------------
    def run(self, verbose: bool = False, encoded=None) -> QualityReport:
        """Execute the grid. ``encoded`` lets callers share one
        ``EncodedDocs`` of the same corpus across several sweeps."""
        from repro_torch.retrieval.indexer import EncodedDocs
        t0 = time.time()
        if encoded is None:
            encoded = EncodedDocs.encode(self.model,
                                         self.dataset.doc_tokens,
                                         self.encode_batch)
        report = QualityReport(
            dataset=self.dataset.name,
            n_docs=self.dataset.n_docs,
            n_queries=self.dataset.n_queries,
            k=max(self.k, max_k(self.metrics)),
            meta={
                "methods": list(self.methods),
                "factors": list(self.factors),
                "backends": list(self.backends),
                "quant_bits": list(self.quant_bits),
                "metrics": list(self.metrics),
                "encode_batch": self.encode_batch,
                "index_overrides": dict(self.index_overrides),
                "dataset_meta": {k: v
                                 for k, v in self.dataset.meta.items()
                                 if isinstance(v, (str, int, float,
                                                   bool))},
            })

        for backend in self.backends:
            bits_grid: Tuple[Optional[int], ...] = (
                self.quant_bits if backend in QUANTIZED_BACKENDS
                else (None,))
            for qb in bits_grid:
                key = baseline_key(backend, qb)
                base_r = self._build(encoded, backend, qb, "none", 1)
                base_metrics = self._evaluate(base_r)
                base_stats = base_r.stats
                report.baselines[key] = QualityBaseline(
                    backend=backend, quant_bits=qb,
                    metrics=dict(base_metrics),
                    n_vectors=base_stats.n_vectors_stored,
                    index_bytes=base_stats.index_bytes)
                if verbose:
                    print(f"[{self.dataset.name}] baseline {key}: "
                          + " ".join(f"{m}={v:.4f}"
                                     for m, v in base_metrics.items()))
                for method in self.methods:
                    for factor in self.factors:
                        if factor <= 1:
                            # factor 1 IS the baseline (identity pool):
                            # share its ranking instead of rebuilding
                            cell = QualityCell(
                                backend=backend, method=method,
                                factor=1, quant_bits=qb,
                                metrics=dict(base_metrics),
                                relative={
                                    m: relative_performance(v, v)
                                    for m, v in base_metrics.items()},
                                n_vectors=base_stats.n_vectors_stored,
                                vector_reduction=0.0,
                                index_bytes=base_stats.index_bytes,
                                shared_baseline=True)
                        else:
                            r = self._build(encoded, backend, qb,
                                            method, factor)
                            m = self._evaluate(r)
                            stats = r.stats
                            cell = QualityCell(
                                backend=backend, method=method,
                                factor=factor, quant_bits=qb,
                                metrics=dict(m),
                                relative={
                                    n: relative_performance(
                                        v, base_metrics[n])
                                    for n, v in m.items()},
                                n_vectors=stats.n_vectors_stored,
                                vector_reduction=stats.vector_reduction,
                                index_bytes=stats.index_bytes)
                        report.cells.append(cell)
                        if verbose:
                            rel = cell.relative.get(self.metrics[0], 0.0)
                            print(f"  {key} {method} f={cell.factor}: "
                                  f"rel {rel:.2f} "
                                  f"({cell.vector_reduction:.1%} fewer "
                                  f"vectors)")
        report.meta["wall_s"] = round(time.time() - t0, 3)
        return report

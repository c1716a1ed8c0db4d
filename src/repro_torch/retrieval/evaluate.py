"""DEPRECATED shim over :mod:`repro_torch.eval` (counterpart of
``src/repro/retrieval/evaluate.py``).

:class:`repro_torch.eval.QualitySweep` encodes the corpus once, shares
the unpooled baseline across cells, and drives only the port's
``Retriever`` facade. This module keeps the original
``evaluate_pooling`` / ``EvalReport`` surface for existing callers by
delegating to the sweep; new code should use ``repro_torch.eval``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.spec import IndexSpec
from repro_torch.data.corpus import SyntheticRetrievalCorpus
from repro_torch.device import DeviceLike
from repro_torch.eval.sweep import (QUANTIZED_BACKENDS,
                                    relative_performance)  # noqa: F401


@dataclass
class PoolingCell:
    method: str
    factor: int
    metric: float
    relative: float               # 100 = baseline
    n_vectors: int
    vector_reduction: float       # fraction of vectors removed
    index_bytes: int


@dataclass
class EvalReport:
    dataset: str
    backend: str
    metric_name: str
    baseline_metric: float
    baseline_vectors: int
    baseline_bytes: int
    cells: List[PoolingCell] = field(default_factory=list)

    def cell(self, method: str, factor: int) -> Optional[PoolingCell]:
        for c in self.cells:
            if c.method == method and c.factor == factor:
                return c
        return None

    def table(self) -> str:
        rows = [f"{'method':12s} {'f':>2s} {'rel':>7s} {'metric':>7s} "
                f"{'vecs':>8s} {'reduct':>7s} {'bytes':>10s}"]
        rows.append(f"{'baseline':12s} {1:2d} {100.0:7.2f} "
                    f"{self.baseline_metric:7.4f} {self.baseline_vectors:8d}"
                    f" {0.0:7.1%} {self.baseline_bytes:10d}")
        for c in self.cells:
            rows.append(f"{c.method:12s} {c.factor:2d} {c.relative:7.2f} "
                        f"{c.metric:7.4f} {c.n_vectors:8d} "
                        f"{c.vector_reduction:7.1%} {c.index_bytes:10d}")
        return "\n".join(rows)


def evaluate_pooling(model, corpus: SyntheticRetrievalCorpus,
                     methods: Sequence[str] = ("ward", "kmeans",
                                               "sequential"),
                     factors: Sequence[int] = (2, 3, 4, 6),
                     backend: str = "plaid",
                     metric_name: str = "ndcg@10",
                     k: int = 10, query_maxlen: Optional[int] = None,
                     device: DeviceLike = None, **index_kw) -> EvalReport:
    """Full paper-protocol evaluation on one dataset (``model``: the
    port's ``ColBERT``; ``device``: ``cuda`` unless given).

    .. deprecated:: use :class:`repro_torch.eval.QualitySweep` — same
       protocol, but the corpus is encoded once and the baseline built
       once instead of per cell.
    """
    warnings.warn(
        "repro_torch.retrieval.evaluate.evaluate_pooling is deprecated; "
        "use repro_torch.eval.QualitySweep (encodes the corpus once and "
        "shares the unpooled baseline across cells)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.eval.datasets import from_corpus
    from repro_torch.eval.sweep import QualitySweep
    cfg = model.cfg

    dataset = from_corpus(corpus, doc_maxlen=cfg.doc_maxlen - 2,
                          query_maxlen=query_maxlen
                          or (cfg.query_maxlen - 2))
    # fold loose **index_kw into a typed spec once, to resolve the
    # backend's quantization default for the sweep's grid key
    spec = IndexSpec.from_config(cfg, backend=backend, **index_kw)
    sweep = QualitySweep(model, dataset,
                         methods=methods, factors=factors,
                         backends=(backend,),
                         quant_bits=(spec.quant_bits,),
                         metrics=(metric_name,), k=k,
                         index_overrides=index_kw, device=device)
    qreport = sweep.run()
    qb = spec.quant_bits if backend in QUANTIZED_BACKENDS else None
    base = qreport.baseline(backend, qb)
    report = EvalReport(dataset=corpus.spec.name, backend=backend,
                        metric_name=metric_name,
                        baseline_metric=base.metrics[metric_name],
                        baseline_vectors=base.n_vectors,
                        baseline_bytes=base.index_bytes)
    for method in methods:
        for factor in factors:
            c = qreport.cell(backend, method, int(factor), qb)
            if c is None:
                continue
            report.cells.append(PoolingCell(
                method=method, factor=int(factor),
                metric=c.metrics[metric_name],
                relative=c.relative[metric_name],
                n_vectors=c.n_vectors,
                vector_reduction=c.vector_reduction,
                index_bytes=c.index_bytes))
    return report


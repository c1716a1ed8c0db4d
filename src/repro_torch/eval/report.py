"""Quality-report artifact (copy of ``src/repro/eval/report.py``): the
paper-style relative-performance table as data.

A :class:`QualityReport` is the output of one ``QualitySweep`` run over
one dataset: per-configuration :class:`QualityCell`s (absolute metric
values, RELATIVE values vs the unpooled baseline — the number every
table in the paper is made of — and footprint stats), plus the
baselines themselves. It round-trips losslessly through JSON and renders
the paper's method x factor grid as markdown
(:meth:`QualityReport.markdown_table`).

A quality file is one JSON document with named sections, merge-updated
by :func:`write_bench_section`. ``BENCH_QUALITY_FILE`` is only the
reference's default file name: the port never writes the repository's
``BENCH_quality.json``; its callers pass a path of their own.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_QUALITY_FILE = "BENCH_quality.json"
SCHEMA_VERSION = 1


def baseline_key(backend: str, quant_bits: Optional[int]) -> str:
    """One baseline per (backend, quantization) — pooling factors under
    the same key share it."""
    return backend if quant_bits is None else f"{backend}@{quant_bits}b"


@dataclass
class QualityCell:
    """One point of the grid: (backend, method, factor, quant_bits)."""
    backend: str
    method: str
    factor: int
    quant_bits: Optional[int]              # None for unquantized backends
    metrics: Dict[str, float]              # name -> absolute value
    relative: Dict[str, float]             # name -> 100 * v / baseline
    n_vectors: int
    vector_reduction: float                # fraction of vectors removed
    index_bytes: int
    shared_baseline: bool = False          # factor-1 cell reusing baseline

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "QualityCell":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class QualityBaseline:
    """The unpooled (factor-1) reference a backend's cells divide by."""
    backend: str
    quant_bits: Optional[int]
    metrics: Dict[str, float]
    n_vectors: int
    index_bytes: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "QualityBaseline":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class QualityReport:
    dataset: str
    n_docs: int
    n_queries: int
    k: int
    baselines: Dict[str, QualityBaseline] = field(default_factory=dict)
    cells: List[QualityCell] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    # ----------------------------------------------------------- lookup
    def cell(self, backend: str, method: str, factor: int,
             quant_bits: Optional[int] = None) -> Optional[QualityCell]:
        for c in self.cells:
            if (c.backend == backend and c.method == method
                    and c.factor == int(factor)
                    and c.quant_bits == quant_bits):
                return c
        return None

    def baseline(self, backend: str,
                 quant_bits: Optional[int] = None
                 ) -> Optional[QualityBaseline]:
        return self.baselines.get(baseline_key(backend, quant_bits))

    # ------------------------------------------------------ round trip
    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "dataset": self.dataset,
            "n_docs": self.n_docs,
            "n_queries": self.n_queries,
            "k": self.k,
            "baselines": {k: b.to_json()
                          for k, b in self.baselines.items()},
            "cells": [c.to_json() for c in self.cells],
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, d: dict) -> "QualityReport":
        return cls(
            dataset=d["dataset"], n_docs=int(d["n_docs"]),
            n_queries=int(d["n_queries"]), k=int(d["k"]),
            baselines={k: QualityBaseline.from_json(b)
                       for k, b in d.get("baselines", {}).items()},
            cells=[QualityCell.from_json(c) for c in d.get("cells", [])],
            meta=dict(d.get("meta", {})))

    # -------------------------------------------------------- rendering
    def markdown_table(self, metric: str = "ndcg@10",
                       backend: Optional[str] = None,
                       quant_bits: Optional[int] = None) -> str:
        """The paper's relative-performance grid (100 = unpooled):
        one row per pooling method, one column per factor."""
        cells = [c for c in self.cells
                 if metric in c.relative
                 and (backend is None or c.backend == backend)
                 and c.quant_bits == quant_bits]
        if not cells:
            return f"(no {metric} cells)"
        methods, factors = [], []
        for c in cells:
            if c.method not in methods:
                methods.append(c.method)
            if c.factor not in factors:
                factors.append(c.factor)
        factors.sort()
        tag = backend or "all"
        if quant_bits is not None:
            tag += f" {quant_bits}-bit"
        lines = [f"| method ({tag}, rel. {metric}) | "
                 + " | ".join(f"f={f}" for f in factors) + " |",
                 "|" + "---|" * (len(factors) + 1)]
        for m in methods:
            row = [f"| {m} "]
            for f in factors:
                c = next((c for c in cells
                          if c.method == m and c.factor == f), None)
                row.append(f"| {c.relative[metric]:.2f} " if c else "| — ")
            lines.append("".join(row) + "|")
        return "\n".join(lines)

    def summary(self, metric: str = "ndcg@10") -> str:
        """Plain-text cell dump (benchmark verbose output)."""
        rows = [f"{'backend':10s} {'method':12s} {'f':>2s} {'bits':>4s} "
                f"{'rel':>7s} {'abs':>7s} {'vecs':>8s} {'reduct':>7s}"]
        for key, b in sorted(self.baselines.items()):
            base = b.metrics.get(metric, 0.0)
            rows.append(f"{key:10s} {'baseline':12s} {1:2d} {'':>4s} "
                        f"{100.0:7.2f} {base:7.4f} {b.n_vectors:8d} "
                        f"{0.0:7.1%}")
        for c in self.cells:
            if metric not in c.relative:
                continue
            bits = "" if c.quant_bits is None else str(c.quant_bits)
            rows.append(f"{c.backend:10s} {c.method:12s} {c.factor:2d} "
                        f"{bits:>4s} {c.relative[metric]:7.2f} "
                        f"{c.metrics[metric]:7.4f} {c.n_vectors:8d} "
                        f"{c.vector_reduction:7.1%}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# BENCH_quality.json sections
# ---------------------------------------------------------------------------
def write_bench_section(path: str, section: str, payload) -> dict:
    """Merge ``payload`` (a QualityReport, a dict of them, or plain
    JSON data) into ``path`` under ``section``, preserving the other
    sections — table1..table4 and the sweep share one artifact."""
    def enc(x):
        if isinstance(x, QualityReport):
            return x.to_json()
        if isinstance(x, dict):
            return {k: enc(v) for k, v in x.items()}
        return x

    doc = {}
    if os.path.isfile(path):
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError):
            doc = {}
    if not isinstance(doc, dict):
        doc = {}
    doc["schema"] = SCHEMA_VERSION
    doc[section] = enc(payload)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc


def read_bench_section(path: str, section: str):
    """Load one section back; QualityReport-shaped sections decode to
    :class:`QualityReport` (the gate's baseline input)."""
    with open(path) as fh:
        doc = json.load(fh)
    if section not in doc:
        raise KeyError(f"{path} has no section {section!r}; found "
                       f"{sorted(k for k in doc if k != 'schema')}")
    data = doc[section]
    if isinstance(data, dict) and "cells" in data and "dataset" in data:
        return QualityReport.from_json(data)
    return data

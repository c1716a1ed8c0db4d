"""Ranking metrics (copy of ``src/repro/retrieval/metrics.py``:
ranx-equivalent formulas, pure numpy).

The paper reports NDCG@10 (BEIR), Success@5 (LoTTe), Recall@5 (Japanese),
always as RELATIVE performance vs the unpooled baseline (100 = baseline).

These per-query Python loops are the REFERENCE implementations: the
batched device metrics in ``repro_torch.eval.metrics`` are pinned against
them (bitwise on the integer gain/rank structures, allclose on the
float means) and are what the quality sweep actually runs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _gains(ranked_ids: Sequence[int], qrel: Dict[int, int],
           k: int) -> np.ndarray:
    return np.array([qrel.get(int(d), 0) for d in ranked_ids[:k]],
                    np.float64)


def ndcg_at_k(ranked: List[Sequence[int]], qrels: List[Dict[int, int]],
              k: int = 10) -> float:
    """Mean NDCG@k with the standard log2 discount and exponential gains."""
    vals = []
    for ids, qrel in zip(ranked, qrels):
        if not qrel:
            continue
        g = _gains(ids, qrel, k)
        disc = 1.0 / np.log2(np.arange(2, len(g) + 2))
        dcg = np.sum((2.0 ** g - 1.0) * disc)
        ideal = np.sort([r for r in qrel.values()])[::-1][:k].astype(float)
        idisc = 1.0 / np.log2(np.arange(2, len(ideal) + 2))
        idcg = np.sum((2.0 ** ideal - 1.0) * idisc)
        vals.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(vals)) if vals else 0.0


def success_at_k(ranked: List[Sequence[int]], qrels: List[Dict[int, int]],
                 k: int = 5) -> float:
    """Fraction of queries with >=1 relevant doc in the top k."""
    vals = []
    for ids, qrel in zip(ranked, qrels):
        if not qrel:
            continue
        vals.append(float(any(qrel.get(int(d), 0) > 0 for d in ids[:k])))
    return float(np.mean(vals)) if vals else 0.0


def recall_at_k(ranked: List[Sequence[int]], qrels: List[Dict[int, int]],
                k: int = 5) -> float:
    """Mean fraction of relevant docs retrieved in the top k."""
    vals = []
    for ids, qrel in zip(ranked, qrels):
        rel = {d for d, r in qrel.items() if r > 0}
        if not rel:
            continue
        hit = sum(1 for d in ids[:k] if int(d) in rel)
        vals.append(hit / len(rel))
    return float(np.mean(vals)) if vals else 0.0


def mrr_at_k(ranked: List[Sequence[int]], qrels: List[Dict[int, int]],
             k: int = 10) -> float:
    """Mean reciprocal rank of the first relevant doc in the top k."""
    vals = []
    for ids, qrel in zip(ranked, qrels):
        if not qrel:
            continue
        rr = 0.0
        for pos, d in enumerate(ids[:k], start=1):
            if qrel.get(int(d), 0) > 0:
                rr = 1.0 / pos
                break
        vals.append(rr)
    return float(np.mean(vals)) if vals else 0.0


METRICS = {"ndcg@10": lambda r, q: ndcg_at_k(r, q, 10),
           "success@5": lambda r, q: success_at_k(r, q, 5),
           "recall@5": lambda r, q: recall_at_k(r, q, 5),
           "mrr@10": lambda r, q: mrr_at_k(r, q, 10)}

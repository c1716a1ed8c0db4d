"""Batched ranking metrics over ``[Nq, k]`` ranked-id matrices, on the
device.

Counterpart of ``src/repro/eval/metrics.py``, whose metrics are
``jax.jit`` programs; here they are eager PyTorch on the device the
caller gives (``cuda`` unless ``device="cpu"``). The numpy loops of
``retrieval/metrics.py`` stay the reference the tests pin against:

  * qrels are packed once into a :class:`PaddedQrels` pair of
    ``[Nq, R]`` id/gain matrices (pad id -1, pad gain 0 — a pad can
    match a ranked -1 pad but contributes zero gain);
  * the per-(query, rank) relevance lookup is an equality match of the
    ranked ids against each query's judged ids, summed against the gain
    matrix — integer work, equal to the dict lookups;
  * each metric (nDCG@k / Recall@k / Success@k / MRR@k) is a masked
    reduction over that gain matrix, in f32.

Every metric is the mean over *scored* queries only, with the
reference's skip conventions: nDCG/Success/MRR skip queries with an
EMPTY qrel dict, Recall skips queries with no positive-gain entry.
Metric names parse as ``"<metric>@<k>"`` (``metric_fn("ndcg@10")``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

METRIC_NAMES = ("ndcg", "recall", "success", "mrr")

# the sweep's default metric set: the paper's three + MRR@10
DEFAULT_METRICS = ("ndcg@10", "recall@5", "success@5", "mrr@10")


# ---------------------------------------------------------------------------
# Qrel packing
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PaddedQrels:
    """Graded qrels as fixed-shape matrices.

    ``ids[i]`` holds query i's judged doc ids (pad -1), ``gains[i]``
    the graded relevance of each (pad 0). ``judged[i]`` is True when
    query i has ANY judgment — the reference metrics' skip mask.
    """
    ids: np.ndarray        # [Nq, R] int32, pad = -1
    gains: np.ndarray      # [Nq, R] int32, pad = 0
    judged: np.ndarray     # [Nq] bool — at least one qrel entry

    @classmethod
    def from_dicts(cls, qrels: Sequence[Dict[int, int]]) -> "PaddedQrels":
        R = max((len(q) for q in qrels), default=0)
        R = max(R, 1)                       # keep shapes non-degenerate
        n = len(qrels)
        ids = np.full((n, R), -1, np.int32)
        gains = np.zeros((n, R), np.int32)
        judged = np.zeros(n, bool)
        for i, q in enumerate(qrels):
            judged[i] = len(q) > 0
            for j, (d, g) in enumerate(q.items()):
                ids[i, j] = int(d)
                gains[i, j] = int(g)
        return cls(ids=ids, gains=gains, judged=judged)

    @classmethod
    def coerce(cls, qrels) -> "PaddedQrels":
        if isinstance(qrels, cls):
            return qrels
        return cls.from_dicts(qrels)

    @property
    def n_queries(self) -> int:
        return self.ids.shape[0]

    @property
    def has_positive(self) -> np.ndarray:
        """[Nq] bool — any positive-gain judgment (Recall's skip mask)."""
        return (self.gains > 0).any(axis=1)


# ---------------------------------------------------------------------------
# Device reductions
# ---------------------------------------------------------------------------
def _gain_matrix(ranked: torch.Tensor, qids: torch.Tensor,
                 qgains: torch.Tensor) -> torch.Tensor:
    """[Nq, k] int64 gain of each ranked doc (0 when unjudged): ranked
    ids matched against each query's judged ids, summed against the
    gains. A ranked pad (-1) can only match a qrel pad, whose gain is 0.
    Equal to the reference's ``qrel.get(int(d), 0)`` loop."""
    match = ranked[:, :, None] == qids[:, None, :]
    return torch.where(match, qgains[:, None, :],
                       torch.zeros((), dtype=qgains.dtype,
                                   device=qgains.device)).sum(-1)


def _discount(n: int, device) -> torch.Tensor:
    return 1.0 / torch.log2(torch.arange(2, n + 2, dtype=torch.float32,
                                         device=device))


def _ndcg(ranked, qids, qgains, k: int) -> torch.Tensor:
    """Per-query nDCG@k values [Nq] f32 (0 where IDCG == 0)."""
    g = _gain_matrix(ranked[:, :k], qids, qgains).float()
    dcg = ((torch.exp2(g) - 1.0) * _discount(g.shape[1], g.device)).sum(1)
    ideal = torch.sort(qgains.float(), dim=1, descending=True).values[:, :k]
    idcg = ((torch.exp2(ideal) - 1.0)
            * _discount(ideal.shape[1], g.device)).sum(1)
    return torch.where(idcg > 0, dcg / idcg.clamp_min(1e-30),
                       torch.zeros_like(dcg))


def _recall(ranked, qids, qgains, k: int) -> torch.Tensor:
    """Per-query Recall@k [Nq] f32 (0 where no positive judgment)."""
    hits = (_gain_matrix(ranked[:, :k], qids, qgains) > 0).sum(1)
    n_rel = (qgains > 0).sum(1)
    return torch.where(n_rel > 0, hits.float() / n_rel.clamp_min(1).float(),
                       torch.zeros(hits.shape, device=hits.device))


def _success(ranked, qids, qgains, k: int) -> torch.Tensor:
    """Per-query Success@k [Nq] f32 — 1.0 iff a positive doc ranks."""
    return (_gain_matrix(ranked[:, :k], qids, qgains) > 0).any(1).float()


def _first_hit_rank(ranked, qids, qgains, k: int) -> torch.Tensor:
    """[Nq] int64 — 1-based rank of the first positive-gain doc in the
    top k, 0 when none ranks (MRR's integer core)."""
    g = _gain_matrix(ranked[:, :k], qids, qgains)
    kk = g.shape[1]
    if kk == 0:
        return torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    pos = torch.arange(1, kk + 1, device=g.device)
    first = torch.where(g > 0, pos[None, :],
                        torch.full_like(g, kk + 1)).amin(1)
    return torch.where(first > kk, torch.zeros_like(first), first)


def _mrr(ranked, qids, qgains, k: int) -> torch.Tensor:
    first = _first_hit_rank(ranked, qids, qgains, k)
    return torch.where(first > 0, 1.0 / first.clamp_min(1).float(),
                       torch.zeros(first.shape, device=first.device))


_DEVICE_FNS = {"ndcg": _ndcg, "recall": _recall, "success": _success,
               "mrr": _mrr}


def _on_device(ranked_ids, qrels, device: DeviceLike):
    """(ranked [Nq, k] int64, qids, qgains, PaddedQrels) on the device."""
    dev = resolve_device(device)
    q = PaddedQrels.coerce(qrels)
    ranked = torch.as_tensor(np.ascontiguousarray(ranked_ids, np.int64),
                             device=dev)
    return (ranked, torch.as_tensor(q.ids, device=dev).long(),
            torch.as_tensor(q.gains, device=dev).long(), q)


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------
def ranked_gains(ranked_ids, qrels, device: DeviceLike = None) -> np.ndarray:
    """[Nq, k] int32 graded gain of every ranked doc — the device
    relevance lookup on its own."""
    ranked, qids, qgains, _ = _on_device(ranked_ids, qrels, device)
    return _gain_matrix(ranked, qids, qgains).cpu().numpy().astype(np.int32)


def first_hit_ranks(ranked_ids, qrels, k: int = 10,
                    device: DeviceLike = None) -> np.ndarray:
    """[Nq] int32 1-based rank of each query's first relevant hit in
    the top k (0 = miss) — MRR's integer core."""
    ranked, qids, qgains, _ = _on_device(ranked_ids, qrels, device)
    return _first_hit_rank(ranked, qids, qgains,
                           k).cpu().numpy().astype(np.int32)


def per_query_values(name: str, ranked_ids, qrels, k: int,
                     device: DeviceLike = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(values [Nq] f32, scored [Nq] bool) for one metric — the device
    computation plus the reference's skip mask, before averaging."""
    if name not in _DEVICE_FNS:
        raise KeyError(f"unknown metric {name!r}; known: {METRIC_NAMES}")
    ranked, qids, qgains, q = _on_device(ranked_ids, qrels, device)
    vals = _DEVICE_FNS[name](ranked, qids, qgains, int(k)).cpu().numpy()
    scored = q.has_positive if name == "recall" else q.judged
    return vals, scored


def _mean_scored(vals: np.ndarray, scored: np.ndarray) -> float:
    if not scored.any():
        return 0.0
    return float(np.mean(vals[scored].astype(np.float64)))


def ndcg_at_k(ranked_ids, qrels, k: int = 10,
              device: DeviceLike = None) -> float:
    """Mean nDCG@k (log2 discount, exponential gains) over judged
    queries, from a [Nq, >=k] ranked-id matrix (-1 pads ignored)."""
    return _mean_scored(*per_query_values("ndcg", ranked_ids, qrels, k,
                                          device))


def recall_at_k(ranked_ids, qrels, k: int = 5,
                device: DeviceLike = None) -> float:
    """Mean fraction of each query's positive docs in the top k."""
    return _mean_scored(*per_query_values("recall", ranked_ids, qrels, k,
                                          device))


def success_at_k(ranked_ids, qrels, k: int = 5,
                 device: DeviceLike = None) -> float:
    """Fraction of judged queries with >= 1 positive doc in the top k."""
    return _mean_scored(*per_query_values("success", ranked_ids, qrels, k,
                                          device))


def mrr_at_k(ranked_ids, qrels, k: int = 10,
             device: DeviceLike = None) -> float:
    """Mean reciprocal rank of the first positive doc in the top k."""
    return _mean_scored(*per_query_values("mrr", ranked_ids, qrels, k,
                                          device))


def parse_metric(name: str) -> Tuple[str, int]:
    """``"ndcg@10"`` -> ``("ndcg", 10)`` with validation."""
    try:
        base, k = name.split("@")
        k = int(k)
    except ValueError:
        raise ValueError(f"metric name must look like 'ndcg@10', "
                         f"got {name!r}")
    if base not in METRIC_NAMES or k < 1:
        raise ValueError(f"unknown metric {name!r}; known bases: "
                         f"{METRIC_NAMES}")
    return base, k


def metric_fn(name: str):
    """Resolve ``"<metric>@<k>"`` to ``fn(ranked_ids, qrels, device=None)
    -> float``."""
    base, k = parse_metric(name)

    def run(ranked_ids, qrels, device: DeviceLike = None, _base=base,
            _k=k):
        return _mean_scored(
            *per_query_values(_base, ranked_ids, qrels, _k, device))
    run.__name__ = name.replace("@", "_at_")
    return run


def compute_metrics(ranked_ids, qrels, names: Sequence[str],
                    device: DeviceLike = None) -> Dict[str, float]:
    """All requested metrics from ONE ranked-id matrix on ``device``
    (``cuda`` unless given); the qrels are packed once."""
    device = resolve_device(device)
    q = PaddedQrels.coerce(qrels)
    return {name: metric_fn(name)(ranked_ids, q, device) for name in names}


def max_k(names: Sequence[str]) -> int:
    """The ranked depth one search must return to score all ``names``."""
    return max((parse_metric(n)[1] for n in names), default=10)


def rankings_matrix(rankings: List[Sequence[int]], k: int) -> np.ndarray:
    """Ragged per-query id lists -> the [Nq, k] -1-padded matrix the
    batched metrics consume (the inverse of ``Searcher.rankings``)."""
    out = np.full((len(rankings), k), -1, np.int64)
    for i, row in enumerate(rankings):
        row = list(row)[:k]
        out[i, :len(row)] = row
    return out

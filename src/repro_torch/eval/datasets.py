"""Evaluation datasets: doc token ids + query token ids + graded qrels
(counterpart of ``src/repro/eval/datasets.py``).

One abstraction (:class:`EvalDataset`) with two providers:

  * :func:`synthetic_dataset` — wraps the port's copy of
    ``data/corpus.py``'s
    :class:`SyntheticRetrievalCorpus` (the offline stand-ins for the
    paper's BEIR/LoTTe/Japanese mix);
  * :func:`load_beir` — the standard BEIR directory layout
    (``corpus.jsonl`` + ``queries.jsonl`` + ``qrels/<split>.tsv``), so
    a real downloaded corpus drops into the same sweep unchanged: text
    is tokenized with the repo's deterministic
    :class:`~repro_torch.data.tokenizer.HashTokenizer` (or any pretrained
    tokenizer passed as ``tokenize=``), string doc ids map to dense
    integer rows, and the qrels come back as the same graded
    per-query dicts the synthetic provider emits.

A dataset is plain data — token matrices and qrel dicts — so the sweep
and :meth:`repro_torch.Retriever.evaluate` never care where it came
from.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.data.corpus import (DATASET_SPECS, DatasetSpec,
                               SyntheticRetrievalCorpus)


@dataclass
class EvalDataset:
    """Graded-relevance retrieval evaluation data, tokenized.

    ``qrels[i]`` maps doc id (row index into ``doc_tokens``) to a
    graded relevance for query i — the structure every metric in
    ``repro_torch.eval.metrics`` consumes.
    """
    name: str
    doc_tokens: np.ndarray                 # [N, L] int32
    query_tokens: np.ndarray               # [Nq, Lq] int32
    qrels: List[Dict[int, int]]
    meta: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        self.doc_tokens = np.asarray(self.doc_tokens, np.int32)
        self.query_tokens = np.asarray(self.query_tokens, np.int32)
        if self.query_tokens.shape[0] != len(self.qrels):
            raise ValueError(
                f"{self.query_tokens.shape[0]} queries but "
                f"{len(self.qrels)} qrel entries")
        n = self.doc_tokens.shape[0]
        for i, q in enumerate(self.qrels):
            for d in q:
                if not 0 <= int(d) < n:
                    raise ValueError(f"qrel {i} references doc {d} "
                                     f"outside [0, {n})")

    @property
    def n_docs(self) -> int:
        return int(self.doc_tokens.shape[0])

    @property
    def n_queries(self) -> int:
        return int(self.query_tokens.shape[0])

    def padded_qrels(self):
        from repro_torch.eval.metrics import PaddedQrels
        return PaddedQrels.from_dicts(self.qrels)


# ---------------------------------------------------------------------------
# Provider: synthetic corpora (the offline default)
# ---------------------------------------------------------------------------
def synthetic_dataset(spec: Union[str, DatasetSpec],
                      vocab_size: int,
                      doc_maxlen: int,
                      query_maxlen: int,
                      n_docs: Optional[int] = None,
                      n_queries: Optional[int] = None,
                      seed: Optional[int] = None) -> EvalDataset:
    """An :class:`EvalDataset` from a named ``DATASET_SPECS`` entry or
    an explicit :class:`DatasetSpec`; ``n_docs``/``n_queries``/``seed``
    override the spec (benchmark wall-time scaling). A name not in
    ``DATASET_SPECS`` makes a fresh default-parameter spec — handy for
    throwaway smoke corpora."""
    if isinstance(spec, str):
        spec = DATASET_SPECS.get(spec) or DatasetSpec(name=spec)
    over = {}
    if n_docs is not None:
        over["n_docs"] = int(n_docs)
    if n_queries is not None:
        over["n_queries"] = int(n_queries)
    if seed is not None:
        over["seed"] = int(seed)
    if over:
        from dataclasses import replace
        spec = replace(spec, **over)
    corpus = SyntheticRetrievalCorpus(spec, vocab_size=vocab_size)
    return from_corpus(corpus, doc_maxlen, query_maxlen)


def from_corpus(corpus: SyntheticRetrievalCorpus, doc_maxlen: int,
                query_maxlen: int) -> EvalDataset:
    """Wrap an already-constructed synthetic corpus (the old
    ``evaluate_pooling`` input shape)."""
    return EvalDataset(
        name=corpus.spec.name,
        doc_tokens=corpus.doc_token_batch(doc_maxlen),
        query_tokens=corpus.query_token_batch(query_maxlen),
        qrels=[dict(q) for q in corpus.qrels],
        meta={"provider": "synthetic", "seed": corpus.spec.seed,
              "n_topics": corpus.spec.n_topics})


# ---------------------------------------------------------------------------
# Provider: BEIR directory layout
# ---------------------------------------------------------------------------
def _read_jsonl(path: str):
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_beir(root: str, doc_maxlen: int, query_maxlen: int,
              split: str = "test",
              tokenize: Optional[Callable[[str, int],
                                          Sequence[int]]] = None,
              vocab_size: int = 30522,
              max_docs: Optional[int] = None,
              name: Optional[str] = None) -> EvalDataset:
    """Load a BEIR-format dataset directory.

    Expected layout (what ``beir.util.download_and_unzip`` produces)::

        root/corpus.jsonl     {"_id": str, "title": str, "text": str}
        root/queries.jsonl    {"_id": str, "text": str}
        root/qrels/<split>.tsv   query-id <TAB> corpus-id <TAB> score

    Only queries that appear in the qrels file are kept (the BEIR
    convention — unjudged queries score nothing). ``tokenize(text,
    max_len) -> token ids`` defaults to the repo's deterministic
    :class:`HashTokenizer`; pass a pretrained tokenizer's encode for a
    real model. ``max_docs`` truncates the corpus for smoke runs —
    qrels pointing past the cut are dropped (and queries left with no
    judgments dropped with them).
    """
    corpus_path = os.path.join(root, "corpus.jsonl")
    queries_path = os.path.join(root, "queries.jsonl")
    qrels_path = os.path.join(root, "qrels", f"{split}.tsv")
    for p in (corpus_path, queries_path, qrels_path):
        if not os.path.isfile(p):
            raise FileNotFoundError(f"BEIR layout missing {p}")

    if tokenize is None:
        from repro_torch.data.tokenizer import HashTokenizer
        tok = HashTokenizer(vocab_size=vocab_size)
        tokenize = tok.encode

    doc_row: Dict[str, int] = {}
    doc_ids_list: List[np.ndarray] = []
    for rec in _read_jsonl(corpus_path):
        if max_docs is not None and len(doc_ids_list) >= max_docs:
            break
        text = " ".join(t for t in (rec.get("title", ""),
                                    rec.get("text", "")) if t)
        doc_row[str(rec["_id"])] = len(doc_ids_list)
        doc_ids_list.append(np.asarray(tokenize(text, doc_maxlen),
                                       np.int32))

    # qrels: query-id -> {doc row: graded score}
    per_query: Dict[str, Dict[int, int]] = {}
    with open(qrels_path) as fh:
        for ln, line in enumerate(fh):
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or (ln == 0 and parts[-1].lower()
                                  in ("score", "rel", "relevance")):
                continue                        # header / blank
            qid, did, score = parts[0], parts[1], parts[2]
            row = doc_row.get(did)
            if row is None:                     # doc beyond max_docs cut
                continue
            per_query.setdefault(qid, {})[row] = int(float(score))

    q_tokens: List[np.ndarray] = []
    qrels: List[Dict[int, int]] = []
    kept_qids: List[str] = []
    for rec in _read_jsonl(queries_path):
        qid = str(rec["_id"])
        judged = per_query.get(qid)
        if not judged:
            continue
        q_tokens.append(np.asarray(tokenize(rec["text"], query_maxlen),
                                   np.int32))
        qrels.append(judged)
        kept_qids.append(qid)
    if not q_tokens:
        raise ValueError(f"no judged queries in {qrels_path}")

    def pad(rows: List[np.ndarray], width: int) -> np.ndarray:
        out = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            k = min(len(r), width)
            out[i, :k] = r[:k]
        return out

    return EvalDataset(
        name=name or os.path.basename(os.path.normpath(root)),
        doc_tokens=pad(doc_ids_list, doc_maxlen),
        query_tokens=pad(q_tokens, query_maxlen),
        qrels=qrels,
        meta={"provider": "beir", "split": split, "root": root,
              "query_ids": kept_qids})

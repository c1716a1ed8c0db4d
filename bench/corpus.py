"""Seeded synthetic topical corpora and queries: the benchmark's frozen
copy of ``repro_torch.data.corpus.SyntheticRetrievalCorpus``.

The same geometry as the program's generator: ``n_topics`` topics, each
with a Zipf-weighted private vocabulary of ``private_vocab`` words, a
shared Zipf-weighted common pool of ``common_vocab`` words from which a
``common_frac`` share of every document's words is drawn, and a quarter
of the documents mixing in words of a second topic; queries are salient
private words of a source document. Word ids start after the special
and punctuation ids (24), so every document token emits a vector.

Three departures, all for the benchmark's sake:

* Every seed gets the same set of document lengths and query lengths,
  in another order: lengths are the normal quantiles of
  ``(i + 0.5) / n`` (clipped to ``[min_len, max_len]``), shuffled by the
  seed. So two seeds ask for the same amount of work.
* A second topic replaces a quarter of a document's private words
  instead of lengthening it (lengths stay the grid's).
* Vectorised draws (inverse-CDF Zipf sampling, one shuffle a row), so a
  corpus of 30,000 documents is made in well under a second; no qrels.

Everything is numpy on the host and depends only on the spec and the
seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

FIRST_WORD_ID = 24          # 8 special ids, then 16 punctuation ids


@dataclass(frozen=True)
class CorpusSpec:
    n_topics: int
    doc_len_mean: float
    doc_len_std: float
    max_len: int                 # longest document body (doc_maxlen - 2)
    common_frac: float
    vocab_size: int
    min_len: int = 16
    private_vocab: int = 400
    common_vocab: int = 1200
    zipf_a: float = 1.3
    secondary_topic_frac: float = 0.25
    query_len: tuple = (4, 10)   # [lo, hi) words a query

    @classmethod
    def from_dict(cls, d: dict, vocab_size: int, max_len: int) -> "CorpusSpec":
        kw = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        if "query_len" in kw:
            kw["query_len"] = tuple(kw["query_len"])
        return cls(vocab_size=vocab_size, max_len=max_len, **kw)


def _zipf_cdf(n: int, a: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** (-a)
    c = np.cumsum(w / w.sum())
    c[-1] = 1.0
    return c


def length_grid(n: int, mean: float, std: float, lo: int, hi: int,
                rng: np.random.Generator) -> np.ndarray:
    """The same n lengths for every seed (normal quantiles), shuffled."""
    nd = NormalDist(mean, std)
    q = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.clip(np.rint(q), lo, hi).astype(np.int64)
    return lens[rng.permutation(n)]


class Corpus:
    """Documents (``doc_tokens`` [n_docs, max_len] int32, 0-padded) and
    queries (``query_tokens`` [n_queries, query_len[1] - 1] int32) of one
    spec and seed. With ``length_groups`` g, each of the g consecutive
    blocks of n_docs / g documents holds the whole length grid."""

    def __init__(self, spec: CorpusSpec, n_docs: int, n_queries: int,
                 seed: int, length_groups: int = 1):
        self.spec = spec
        rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
        nw = spec.vocab_size - FIRST_WORD_ID
        need = spec.n_topics * spec.private_vocab + spec.common_vocab
        scale = min(1.0, nw / need)
        pv = max(8, int(spec.private_vocab * scale))
        cv = max(16, int(spec.common_vocab * scale))
        perm = rng.permutation(nw)[:spec.n_topics * pv + cv] + FIRST_WORD_ID
        self.common = perm[:cv]
        self.topics = perm[cv:].reshape(spec.n_topics, pv)
        cdf_p, cdf_c = _zipf_cdf(pv, spec.zipf_a), _zipf_cdf(cv, spec.zipf_a)

        g = n_docs // length_groups
        lens = np.concatenate([length_grid(
            g, spec.doc_len_mean, spec.doc_len_std, spec.min_len,
            spec.max_len, rng) for _ in range(length_groups)])
        L = spec.max_len
        topic = rng.integers(0, spec.n_topics, n_docs)
        second = np.where(rng.random(n_docs) < spec.secondary_topic_frac,
                          rng.integers(0, spec.n_topics, n_docs), -1)
        n_common = (lens * spec.common_frac).astype(np.int64)
        n_priv = lens - n_common
        pos = np.arange(L)[None, :]
        # private ranks from the Zipf CDF; a second topic takes the last
        # quarter of the private slots
        pr = np.searchsorted(cdf_p, rng.random((n_docs, L)))
        ptopic = np.where((second[:, None] >= 0)
                          & (pos >= n_priv[:, None] - n_priv[:, None] // 4),
                          second[:, None], topic[:, None])
        priv = self.topics[ptopic, pr]
        com = self.common[np.searchsorted(cdf_c, rng.random((n_docs, L)))]
        words = np.where(pos < n_priv[:, None], priv, com)
        words = np.where(pos < lens[:, None], words, 0)
        # shuffle each document's words in place, padding kept last
        keys = np.where(pos < lens[:, None], rng.random((n_docs, L)), 2.0)
        order = np.argsort(keys, axis=1, kind="stable")
        self.doc_tokens = np.take_along_axis(words, order, 1).astype(np.int32)
        self.doc_lens = lens

        # queries: distinct private-slot positions of a source document
        qlo, qhi = spec.query_len
        qlens = (np.arange(n_queries) % (qhi - qlo)) + qlo
        qlens = qlens[rng.permutation(n_queries)]
        src = rng.integers(0, n_docs, n_queries)
        width = qhi - 1
        q = np.zeros((n_queries, width), np.int32)
        for i in range(n_queries):
            d = src[i]
            k = int(min(qlens[i], n_priv[d]))
            take = rng.permutation(int(n_priv[d]))[:k]
            q[i, :k] = priv[d, take]
        self.query_tokens = q
        self.query_src = src

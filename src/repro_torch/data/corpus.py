"""Synthetic topical retrieval corpora (copy of ``src/repro/data/corpus.py``).

No BEIR/LoTTe/MS-Marco data ships with the repository, so we synthesize corpora whose
*relative* measurements reproduce the paper's experimental geometry:

  * T latent topics, each with a Zipf-weighted private vocabulary plus a
    shared common-word pool (so token vectors within a doc are partially
    redundant — the redundancy token pooling exploits).
  * Documents sample one primary topic (+ optional secondary) and draw
    words from the mixed distribution.
  * Queries are generated FROM a source document (salient private words),
    giving graded qrels: source doc rel=2, same-topic docs rel=1.

``DATASET_SPECS`` defines several named datasets with different sizes,
doc lengths and vocab-overlap levels, mirroring the paper's small/mid BEIR
mix (scifact/scidocs/nfcorpus/fiqa/trec-covid/touche + LoTTe splits) plus
two "Japanese" analogues (different token-length statistics, doc_len=300).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.tokenizer import FIRST_WORD_ID


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_docs: int = 512
    n_queries: int = 64
    n_topics: int = 16
    doc_len_mean: int = 120
    doc_len_std: int = 40
    query_len: Tuple[int, int] = (4, 10)
    private_vocab: int = 400       # words per topic
    common_vocab: int = 1200       # shared pool
    common_frac: float = 0.45      # fraction of doc words from common pool
    zipf_a: float = 1.3
    secondary_topic_frac: float = 0.25
    seed: int = 0


# Named datasets standing in for the paper's evaluation mix.
DATASET_SPECS: Dict[str, DatasetSpec] = {
    # BEIR-like (small)
    "scifact": DatasetSpec("scifact", n_docs=600, n_queries=80, n_topics=20,
                           doc_len_mean=160, common_frac=0.35, seed=101),
    "scidocs": DatasetSpec("scidocs", n_docs=800, n_queries=80, n_topics=24,
                           doc_len_mean=140, common_frac=0.5, seed=102),
    "nfcorpus": DatasetSpec("nfcorpus", n_docs=500, n_queries=72,
                            n_topics=14, doc_len_mean=180,
                            common_frac=0.4, seed=103),
    "fiqa": DatasetSpec("fiqa", n_docs=900, n_queries=96, n_topics=30,
                        doc_len_mean=110, common_frac=0.55,
                        query_len=(3, 7), seed=104),
    # BEIR-like (mid, quantized-only in the paper)
    "trec-covid": DatasetSpec("trec-covid", n_docs=1200, n_queries=64,
                              n_topics=18, doc_len_mean=200,
                              common_frac=0.45, seed=105),
    "touche": DatasetSpec("touche", n_docs=1000, n_queries=64, n_topics=12,
                          doc_len_mean=220, common_frac=0.65, seed=106),
    # LoTTe-like
    "lotte-writing": DatasetSpec("lotte-writing", n_docs=900, n_queries=96,
                                 n_topics=26, doc_len_mean=100,
                                 common_frac=0.5, seed=107),
    "lotte-recreation": DatasetSpec("lotte-recreation", n_docs=900,
                                    n_queries=96, n_topics=26,
                                    doc_len_mean=90, common_frac=0.5,
                                    seed=108),
    "lotte-lifestyle": DatasetSpec("lotte-lifestyle", n_docs=900,
                                   n_queries=96, n_topics=26,
                                   doc_len_mean=95, common_frac=0.5,
                                   seed=109),
    # Japanese analogues (longer docs, denser tokenization)
    "jsquad": DatasetSpec("jsquad", n_docs=700, n_queries=80, n_topics=22,
                          doc_len_mean=240, doc_len_std=50,
                          common_frac=0.4, seed=110),
    "miracl-ja": DatasetSpec("miracl-ja", n_docs=800, n_queries=80,
                             n_topics=24, doc_len_mean=260, doc_len_std=60,
                             common_frac=0.45, seed=111),
}


class SyntheticRetrievalCorpus:
    """Token-id documents + queries + graded qrels for one DatasetSpec."""

    def __init__(self, spec: DatasetSpec, vocab_size: int = 30522):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        nw = vocab_size - FIRST_WORD_ID
        # carve disjoint private vocabularies + a common pool out of word
        # ids; scale the pools down proportionally for small test vocabs
        need = spec.n_topics * spec.private_vocab + spec.common_vocab
        scale = min(1.0, nw / need)
        private_vocab = max(8, int(spec.private_vocab * scale))
        common_vocab = max(16, int(spec.common_vocab * scale))
        perm = rng.permutation(nw)[:spec.n_topics * private_vocab
                                   + common_vocab] + FIRST_WORD_ID
        self.common = perm[:common_vocab]
        priv = perm[common_vocab:]
        self.topics = priv.reshape(spec.n_topics, private_vocab)
        spec = DatasetSpec(**{**spec.__dict__,
                              "private_vocab": private_vocab,
                              "common_vocab": common_vocab})
        self.spec = spec
        # Zipf weights (shared shape; per-topic word identity differs)
        ranks = np.arange(1, private_vocab + 1)
        w = ranks ** (-spec.zipf_a)
        self.zipf_p = w / w.sum()
        rc = np.arange(1, spec.common_vocab + 1)
        wc = rc ** (-spec.zipf_a)
        self.zipf_c = wc / wc.sum()

        self.doc_topic = rng.integers(0, spec.n_topics, spec.n_docs)
        self.docs: List[np.ndarray] = []
        for i in range(spec.n_docs):
            L = max(16, int(rng.normal(spec.doc_len_mean, spec.doc_len_std)))
            t = self.doc_topic[i]
            n_common = int(L * spec.common_frac)
            n_priv = L - n_common
            words = [rng.choice(self.topics[t], n_priv, p=self.zipf_p),
                     rng.choice(self.common, n_common, p=self.zipf_c)]
            if rng.random() < spec.secondary_topic_frac:
                t2 = rng.integers(0, spec.n_topics)
                n2 = n_priv // 4
                words.append(rng.choice(self.topics[t2], n2, p=self.zipf_p))
            doc = np.concatenate(words)
            rng.shuffle(doc)
            self.docs.append(doc.astype(np.int32))

        # queries from source docs: salient (low-rank) private words
        self.queries: List[np.ndarray] = []
        self.qrels: List[Dict[int, int]] = []
        src_docs = rng.choice(spec.n_docs, spec.n_queries, replace=False)
        for d in src_docs:
            t = self.doc_topic[d]
            qlen = rng.integers(*spec.query_len)
            doc_words = self.docs[d]
            priv_words = doc_words[np.isin(doc_words, self.topics[t])]
            if len(priv_words) == 0:
                priv_words = self.topics[t][:8]
            q = rng.choice(priv_words, min(qlen, len(priv_words)),
                           replace=False)
            self.queries.append(q.astype(np.int32))
            rel = {int(d): 2}
            same = np.nonzero(self.doc_topic == t)[0]
            overlap_scores = []
            qset = set(int(x) for x in q)
            for s in same:
                if s == d:
                    continue
                ov = len(qset & set(int(x) for x in self.docs[s]))
                overlap_scores.append((ov, int(s)))
            overlap_scores.sort(reverse=True)
            for ov, s in overlap_scores[:10]:
                if ov > 0:
                    rel[s] = 1
            self.qrels.append(rel)

    # ------------------------------------------------------------- batching
    def doc_token_batch(self, maxlen: int) -> np.ndarray:
        out = np.zeros((len(self.docs), maxlen), np.int32)
        for i, d in enumerate(self.docs):
            k = min(len(d), maxlen)
            out[i, :k] = d[:k]
        return out

    def query_token_batch(self, maxlen: int) -> np.ndarray:
        out = np.zeros((len(self.queries), maxlen), np.int32)
        for i, q in enumerate(self.queries):
            k = min(len(q), maxlen)
            out[i, :k] = q[:k]
        return out

    def train_pairs(self, n: int, seed: int = 0):
        """(query_tokens, positive_doc_id) pairs for contrastive training."""
        rng = np.random.default_rng(seed)
        qs, ds = [], []
        for _ in range(n):
            d = int(rng.integers(0, self.spec.n_docs))
            t = self.doc_topic[d]
            doc_words = self.docs[d]
            priv = doc_words[np.isin(doc_words, self.topics[t])]
            if len(priv) == 0:
                priv = doc_words
            qlen = int(rng.integers(*self.spec.query_len))
            q = rng.choice(priv, min(qlen, len(priv)), replace=False)
            qs.append(q.astype(np.int32))
            ds.append(d)
        return qs, np.asarray(ds)

"""The seeded traffic and the rates of the windows."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.corpus import FIRST_WORD_ID, Corpus, CorpusSpec  # noqa: E402

SPEC = CorpusSpec(n_topics=6, doc_len_mean=40, doc_len_std=10, max_len=62,
                  common_frac=0.45, vocab_size=2000)


def test_corpus_repeats_exactly():
    a, b = Corpus(SPEC, 200, 30, 2 ** 33 + 5), Corpus(SPEC, 200, 30, 2 ** 33 + 5)
    assert np.array_equal(a.doc_tokens, b.doc_tokens)
    assert np.array_equal(a.query_tokens, b.query_tokens)


def test_corpus_seeds_share_sizes_not_words():
    a, b = Corpus(SPEC, 200, 30, 1), Corpus(SPEC, 200, 30, 2)
    assert not np.array_equal(a.doc_tokens, b.doc_tokens)
    assert np.array_equal(np.sort((a.doc_tokens > 0).sum(1)),
                          np.sort((b.doc_tokens > 0).sum(1)))
    assert np.array_equal(np.sort((a.query_tokens > 0).sum(1)),
                          np.sort((b.query_tokens > 0).sum(1)))


def test_corpus_shape_and_ids():
    c = Corpus(SPEC, 300, 40, 7)
    lens = (c.doc_tokens > 0).sum(1)
    assert c.doc_tokens.shape == (300, 62) and lens.max() <= 62
    assert abs(lens.mean() - 40) < 1.5
    words = c.doc_tokens[c.doc_tokens > 0]
    assert words.min() >= FIRST_WORD_ID and words.max() < 2000
    # padding only after the words
    assert all((row[n:] == 0).all() for row, n in zip(c.doc_tokens, lens))
    q = c.query_tokens
    assert ((q > 0).sum(1) >= 4).all() and q.shape[1] == 9


def test_closed_loop_rate_is_over_the_whole_window():
    from bench.jobs import ClosedBatchJob

    class _Retriever:
        def __init__(self):
            self.calls = 0

        def search(self, batch, k):
            self.calls += 1
            time.sleep(0.2 if self.calls == 2 else 0.01)
            return np.zeros((len(batch), k)), np.zeros((len(batch), k))

    job = ClosedBatchJob.__new__(ClosedBatchJob)
    job.traffic = {"k": 10}
    job.attempted = 0
    job.batches = [np.ones((8, 9), np.int32)] * 2
    job.retriever = _Retriever()
    job.window(0.3)
    qps = job.end_to_end()["search_qps"][0]
    answered = 8 * job.retriever.calls
    assert qps == pytest.approx(answered / job.wall_s)
    assert job.wall_s >= 0.3 and qps < 8 / 0.01


def test_build_rate_is_over_the_whole_window():
    """Builds start until the window has passed and the last one runs to
    its end; one slow build lowers the rate of the whole window."""
    from bench.jobs import BuildJob

    class _Stats:
        n_docs = 8

    class _Indexer:
        calls = 0

        def build(self, tokens, out_dir):
            _Indexer.calls += 1
            time.sleep(0.2 if _Indexer.calls == 2 else 0.01)
            return None, _Stats()

    job = BuildJob.__new__(BuildJob)
    job.traffic = {"docs_per_build": 8}
    job.attempted = 0
    job.kept = []
    job.slices = [np.ones((8, 9), np.int32)] * 3
    job.indexer = _Indexer
    job.out_dir = str(Path(__file__).parent)
    job.window(0.3)
    docs = 8 * _Indexer.calls
    rate = docs / job.wall_s
    assert job.wall_s >= 0.3 and job.attempted == _Indexer.calls
    assert [b[0] for b in job.builds] == [i % 3 for i in range(docs // 8)]
    assert rate < 8 / 0.01

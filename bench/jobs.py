"""The kinds of traffic a cell can run, one class each, chosen by the
``kind`` of the traffic file:

* ``build``: back-to-back whole builds (``Indexer.build`` with an
  artifact directory), each a fresh indexer over the next slice of a
  pool of document slices;
* ``closed_batch``: one closed-loop client sending fixed batches of
  queries through ``Retriever.search``.

Each job makes its inputs and weights from the seed (``setup``, which
warms every shape its traffic uses), measures for the window
(``window``), reports its end-to-end metrics, fills the per-layer
readers' context after a traced window, frees the program's state
(``release``) and hands its outputs to the check (``judge``).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from bench import program, roofline
from bench.corpus import Corpus, CorpusSpec
from bench.weights import make_weights


def _free():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Job:
    def __init__(self, cell: str, cfg: dict, traffic: dict, seed: int,
                 device, work_dir: str):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.work_dir = work_dir
        self.seed = int(seed)
        self.device = torch.device(device)
        self.model_cfg = cfg["model"]
        self.ctx: dict = {}
        self.attempted = 0
        self.failed = 0
        self.parts: dict = {}

    @contextmanager
    def part(self, name: str):
        """Host seconds of a set-up step, synchronised, for the record."""
        t0 = time.perf_counter()
        yield
        _sync()
        self.parts[name] = time.perf_counter() - t0

    def corpus(self, n_docs: int, n_queries: int, groups: int = 1) -> Corpus:
        m = self.model_cfg
        spec = CorpusSpec.from_dict(self.traffic["corpus"], m["vocab_size"],
                                    m["doc_maxlen"] - 2)
        with self.part("corpus"):
            return Corpus(spec, n_docs, n_queries, self.seed, groups)

    def model(self):
        with self.part("weights"):
            self.weights = make_weights(self.model_cfg, self.seed,
                                        self.device)
            return program.build_model(self.cfg, self.weights, self.device)

    def encode(self, tokens: np.ndarray):
        """The program's encodings of ``tokens`` at the build's encode
        batch (``EncodedDocs``): (x [N, L, dim] f32, emit [N, L])."""
        from repro_torch.retrieval.indexer import EncodedDocs
        enc = EncodedDocs.encode(self.net, tokens,
                                 self.traffic["encode_batch"])
        return enc, (torch.cat([v[:n] for v, _, n in enc.batches]),
                     torch.cat([e[:n] for _, e, n in enc.batches]))

    def doc_tokens_per_doc(self, tokens: np.ndarray) -> np.ndarray:
        """Positions each document takes in the encoder: [CLS][D] and its
        body up to doc_maxlen."""
        body = np.minimum((tokens != 0).sum(1), self.model_cfg["doc_maxlen"]
                          - 2)
        return body + 2


class BuildJob(Job):
    def setup(self):
        from repro_torch.retrieval.indexer import Indexer
        t = self.traffic
        D, P = t["docs_per_build"], t["pool_slices"]
        c = self.corpus(D * P, t["check_queries"], P)
        self.slices = [c.doc_tokens[i * D:(i + 1) * D] for i in range(P)]
        self.check_queries = c.query_tokens
        self.slice_flops = [roofline.encoder_flops(
            self.model_cfg, self.doc_tokens_per_doc(s)) for s in self.slices]
        self.net = self.model()
        self.index_spec, self.pool_spec = program.specs(self.cfg)
        self.out_dir = os.path.join(self.work_dir, "index")
        self.indexer = lambda: Indexer(
            self.net, index_spec=self.index_spec, pooling_spec=self.pool_spec,
            encode_batch=t["encode_batch"], device=self.device)
        self._keep_encodings()
        with self.part("warm_build"):
            self.indexer().build(self.slices[0], out_dir=self.out_dir)

    def _keep_encodings(self):
        """Hold what the build's encoder gives each encode batch, so the
        check judges the timed build's own encodings: a reference to each
        output (no copy), dropped when the next build starts."""
        import repro_torch.retrieval.indexer as indexer
        inner = indexer.encode_docs
        kept = self.kept = []

        def encode_docs(model, chunk):
            v, emit = inner(model, chunk)
            kept.append((v, emit))
            return v, emit

        indexer.encode_docs = encode_docs
        self._restore = lambda: setattr(indexer, "encode_docs", inner)

    def window(self, seconds: float, traced: bool = False):
        self.builds = []
        t0 = time.perf_counter()
        i = 0
        while True:
            s = i % len(self.slices)
            self.attempted += 1
            self.kept.clear()
            tb = time.perf_counter()
            index, stats = self.indexer().build(self.slices[s],
                                                out_dir=self.out_dir)
            del index
            _sync()
            te = time.perf_counter()
            self.builds.append((s, stats, te - tb))
            i += 1
            if te - t0 >= seconds:
                break
        self.wall_s = te - t0
        self.last_slice = self.builds[-1][0]
        self.artifact_bytes = sum(
            os.path.getsize(os.path.join(self.out_dir, f))
            for f in os.listdir(self.out_dir))

    def end_to_end(self) -> dict:
        docs = sum(b[1].n_docs for b in self.builds)
        D = self.traffic["docs_per_build"]
        return {"build_docs_per_s": (docs / self.wall_s, "docs/s"),
                "index_bytes_per_doc": (self.artifact_bytes / D, "B/doc")}

    def fill_ctx(self):
        stages: dict = {}
        for _, st, _ in self.builds:
            for k, v in st.stage_seconds.items():
                stages[k] = stages.get(k, 0.0) + v
        self.ctx.update(
            stage_s=stages, docs=sum(b[1].n_docs for b in self.builds),
            stored=sum(b[1].n_vectors_stored for b in self.builds),
            flops_bf16=sum(self.slice_flops[b[0]] for b in self.builds))

    def keep_state(self):
        """The encodings the last timed build made of its documents,
        which the reference checks and follows."""
        self._restore()
        n = len(self.slices[self.last_slice])
        self.encodings = (torch.cat([v for v, _ in self.kept])[:n],
                          torch.cat([e for _, e in self.kept])[:n])
        self.kept.clear()

    def release(self):
        self._restore()
        del self.net, self.indexer
        _free()

    def judge(self, ref):
        from bench.reference import check
        return check.judge_build(self, ref)


class SearchJob(Job):
    """What a search kind needs: the corpus, the index built at set-up
    through ``Indexer.build``, the retriever."""

    def build_index(self):
        from repro_torch.core.spec import RetrieverSpec
        from repro_torch.api import Retriever
        from repro_torch.retrieval.indexer import Indexer
        t = self.traffic
        c = self.corpus(t["n_docs"], t["n_queries"])
        self.docs = c.doc_tokens
        self.queries = c.query_tokens
        self.net = self.model()
        index_spec, pool_spec = program.specs(self.cfg)
        with self.part("encode"):
            enc, self.encodings = self.encode(self.docs)
        # the artifact is the index's state as searched, which the check
        # follows
        self.out_dir = os.path.join(self.work_dir, "index")
        with self.part("index_build"):
            index, _ = Indexer(self.net, index_spec=index_spec,
                               pooling_spec=pool_spec,
                               encode_batch=t["encode_batch"],
                               device=self.device).build(
                                   enc, out_dir=self.out_dir)
        del enc
        self.retriever = Retriever(
            self.net, index, RetrieverSpec(pooling=pool_spec,
                                           index=index_spec),
            encode_batch=t["query_encode_batch"])

    def judge(self, ref):
        from bench.reference import check
        return check.judge_search(self, ref)

    def keep_state(self):
        """The encodings the set-up's index was built from (kept since
        set-up)."""

    def sample(self, n_results: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 11]))
        k = min(self.traffic["check_sample"], n_results)
        return np.sort(rng.choice(n_results, k, replace=False))


class ClosedBatchJob(SearchJob):
    def setup(self):
        self.build_index()
        B = self.traffic["batch"]
        n = len(self.queries) // B
        self.batches = [self.queries[j * B:(j + 1) * B] for j in range(n)]
        before = program.launches()
        with self.part("warm_search"):
            for b in self.batches:
                self.retriever.search(b, k=self.traffic["k"])
        after = program.launches()
        for name in (("plaid_probe", "maxsim_packed")
                     if self.device.type == "cuda" else ()):
            if after.get(name, 0) <= before.get(name, 0):
                raise RuntimeError(f"the warm-up launched no {name}: the "
                                   f"cell has left the device probe path")

    def window(self, seconds: float, traced: bool = False):
        k = self.traffic["k"]
        self.results, self.spans = [], {"query_encode": [],
                                        "index_search": []}
        t0 = time.perf_counter()
        n = 0
        while True:
            j = n % len(self.batches)
            self.attempted += len(self.batches[j])
            if traced:
                s = self.retriever.searcher
                ta = time.perf_counter()
                enc = s.encode_queries(self.batches[j])
                _sync()
                tb = time.perf_counter()
                S, I = s.search_encoded(enc, k=k)
                tc = time.perf_counter()
                self.spans["query_encode"].append(tb - ta)
                self.spans["index_search"].append(tc - tb)
            else:
                S, I = self.retriever.search(self.batches[j], k=k)
            te = time.perf_counter()
            self.results.append((j, S, I))
            n += 1
            if te - t0 >= seconds:
                break
        self.wall_s = te - t0

    def end_to_end(self) -> dict:
        answered = sum(len(S) for _, S, _ in self.results)
        return {"search_qps": (answered / self.wall_s, "queries/s")}

    def fill_ctx(self):
        answered = sum(len(S) for _, S, _ in self.results)
        self.ctx.update(spans=self.spans, queries=answered,
                        flops_bf16=roofline.encoder_flops(
                            self.model_cfg,
                            [self.model_cfg["query_maxlen"]]) * answered)

    def answers(self):
        """(query index, scores [k], ids [k]) of every answered query."""
        B = self.traffic["batch"]
        for j, S, I in self.results:
            for r in range(len(S)):
                yield j * B + r, S[r], I[r]

    def release(self):
        del self.retriever, self.net
        _free()


KINDS = {"build": BuildJob, "closed_batch": ClosedBatchJob}

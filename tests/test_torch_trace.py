"""The program's spans and counters (``repro_torch/trace.py``), on the CPU
at SMOKE size: what they cost with no profiler and no counting window,
the span tree a profiler session sees in a PLAID build and a
device-path search, and the search counters against direct counts."""
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch as rt
from repro_torch import trace
from repro_torch.core import index as tindex
from repro_torch.core import maxsim as tmaxsim
from repro_torch.core import plaid as tplaid
from repro_torch.core.spec import IndexSpec, PoolingSpec
from repro_torch.retrieval import indexer as tindexer
from repro_torch.retrieval import searcher as tsearcher

# each program span and its parent span (None: a root)
TREE = {"build.encode": None, "build.pool": None, "build.index": None,
        "build.kmeans": "build.index", "build.codec": "build.index",
        "build.codes": "build.index", "build.ivf": "build.index",
        "build.views": "build.index", "build.save": None,
        "search.encode": None, "search.index": None,
        **{f"search.{s}": "search.index" for s in (
            "centroid_scores", "probe_members", "code_gather",
            "plaid_probe", "prune", "packed_gather", "maxsim_packed",
            "topk")}}
SITES = (tplaid, tmaxsim, tindex, tindexer, tsearcher)


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    model = rt.init_colbert(rt.SMOKE, device="cpu")
    rng = np.random.default_rng(0)
    docs = rng.integers(5, 1000, size=(96, 30)).astype(np.int32)
    queries = rng.integers(5, 1000, size=(16, 6)).astype(np.int32)
    spec = IndexSpec(backend="plaid", doc_maxlen=48, n_centroids=16,
                     quant_bits=2, nprobe=2, t_cs=0.3, ndocs=16)
    indexer = rt.Indexer(model, index_spec=spec,
                         pooling_spec=PoolingSpec("ward", 2),
                         encode_batch=32, device="cpu")
    return model, docs, queries, indexer


def _searcher(setup):
    model, docs, queries, indexer = setup
    index, _ = indexer.build(docs)
    return rt.Searcher(model, index, encode_batch=8), queries


def _aten_ops(fn):
    """The aten ops ``fn`` runs, in order."""
    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return ops


def test_no_profiler_no_window_costs_no_call_and_no_tensor(setup,
                                                           monkeypatch):
    """With no profiler session, ``span`` never reaches
    ``record_function``; with no counting window, the count sites run
    no op beyond the program's (the same ops as with every site
    stubbed out) and hand ``count`` host ints only."""
    searcher, queries = _searcher(setup)
    qv = searcher.encode_queries(queries[:8])
    searcher.search_encoded(qv, k=5)    # the views and caches of a first call
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name))
    counted = []
    real_count = trace.count

    def fake_count(name, value):
        counted.append((name, type(value)))
        real_count(name, value)

    for mod in SITES:
        if hasattr(mod, "count"):
            monkeypatch.setattr(mod, "count", fake_count)
    ops = _aten_ops(lambda: searcher.search_encoded(qv, k=5))
    setup[3].build(setup[1][:40])
    assert entered == []
    assert counted and all(t is int for _, t in counted), counted
    with monkeypatch.context() as m:
        for mod in SITES:
            for name, stub in (("count", lambda n, v: None),
                               ("counting_open", lambda: False),
                               ("span", lambda n: trace._NULL)):
                if hasattr(mod, name):
                    m.setattr(mod, name, stub)
        stubbed = _aten_ops(lambda: searcher.search_encoded(qv, k=5))
    assert ops == stubbed
    with trace.counting():
        opened = _aten_ops(lambda: searcher.search_encoded(qv, k=5))
    assert len(opened) > len(ops)       # the device count's sum


def test_profiled_build_and_search_show_every_span_nested(setup, tmp_path):
    model, docs, queries, indexer = setup
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index, stats = indexer.build(docs, out_dir=str(tmp_path / "ix"))
        searcher = rt.Searcher(model, index, encode_batch=8)
        searcher.search(queries[:8], k=5)
    assert set(stats.stage_seconds) == {"encode", "pool", "index", "save"}
    parents = {}
    for e in prof.events():
        if not e.name.startswith(("search.", "build.")):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(("search.", "build.")):
            p = p.cpu_parent
        parents.setdefault(e.name, set()).add(p.name if p else None)
    assert parents == {k: {v} for k, v in TREE.items()}


def test_search_counters_on_the_device_path(setup):
    """Three host reads a device-path batch; the prune's slots and its
    valid candidates against a direct count (top-nprobe centroids of
    each query token, every document with a vector in one of them)."""
    searcher, queries = _searcher(setup)
    index = searcher.index
    pl = index._plaid
    batches = [queries[:8], queries[8:]]
    qvs = [searcher.encode_queries(b) for b in batches]
    use, geom = tplaid.device_probe_plan(pl, qvs[0].shape[1], index.nprobe,
                                         index.ndocs)
    assert use
    c_score = geom[2]
    with trace.counting() as counters:
        for qv in qvs:
            searcher.search_encoded(qv, k=5)
        assert counters == {}           # filled when the window closes
    assign = pl.assignments.numpy()
    cents = pl.codec.centroids.numpy()
    want = 0
    for qv in qvs:
        for q in qv.numpy():
            cs = q @ cents.T                                # [Lq, K]
            probed = np.argsort(-cs, axis=1, kind="stable")[:, :index.nprobe]
            hit = np.isin(assign, probed.ravel())
            want += len(np.unique(pl.vec2doc[hit]))
    assert counters == {"search.batches": 2, "search.host_reads": 6,
                        "search.probe_slots": 16 * c_score,
                        "search.probe_candidates": want}


def test_counts_from_two_threads_add_up():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n = 4000

    def work():
        for _ in range(n):
            trace.count("host", 1)
            trace.count("device", torch.tensor(2))

    try:
        with trace.counting() as counters:
            threads = [threading.Thread(target=work) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counters == {"host": 2 * n, "device": 4 * n}
    assert not trace.counting_open()


def test_one_window_at_a_time():
    trace.count("lost", 1)              # no window: nothing kept
    with trace.counting() as outer:
        with pytest.raises(RuntimeError):
            with trace.counting():
                pass
        trace.count("kept", 3)
    assert outer == {"kept": 3}

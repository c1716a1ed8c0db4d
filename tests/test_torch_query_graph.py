"""The query encode replayed as one CUDA graph (``models.colbert.
QueryGraph``, taken by ``Searcher.encode_queries``).

On the CPU:

* the rule that takes the graph (``query_graph_blockers``), case by
  case: a CPU or ``meta`` model, grad mode on, an active sharding
  context and a ``DTensor`` parameter each name their reason, and the
  searcher then encodes eagerly;
* ``Searcher.encode_queries`` equals ``models.colbert.encode_queries``
  a chunk (padded to ``encode_batch``) bit for bit at raw widths
  shorter than, equal to and longer than the body width, with the
  counters at chunks n, replays 0, captures 0;
* the graph's host staging (``QueryGraph.stage``) and the encode it
  holds (``encode_ids``), run eagerly, give the eager path's tokens and
  vectors bit for bit.

On the card (marked ``cuda``; each test skips where no CUDA device
exists, the fixture decides at run time): the graph equals the eager
path bit for bit over three batches, a partial chunk and an odd raw
width, also at JaColBERTv2's width ([256, 32]); a first call's result
is unchanged by a second; an in-place weight change is seen with no
new capture; a replaced parameter is captured anew; two threads
replaying get the eager results. Run there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_query_graph.py``.
"""
import threading

import numpy as np
import pytest
import torch
from torch import nn

import repro_torch as rt
from repro_torch.models.colbert import (PAD_ID, QueryGraph, encode_queries,
                                        init_colbert, prepare_query_tokens,
                                        query_graph_blockers)
from repro_torch.retrieval.searcher import Searcher
from repro_torch.sharding.api import mesh_context
from repro_torch.trace import counting

CFG = rt.SMOKE
BODY = CFG.query_maxlen - 2
WIDTHS = [3, BODY, BODY + 5]


def _queries(n, width, seed=0, vocab=None):
    rng = np.random.default_rng(seed)
    q = rng.integers(8, vocab or CFG.trunk.vocab_size, (n, width))
    q[:, width // 2:] *= rng.random((n, width - width // 2)) < 0.5  # pads
    return q.astype(np.int64)


def _eager(model, queries, batch):
    """The searcher's eager path: chunks padded to ``batch`` rows."""
    out = []
    for lo in range(0, len(queries), batch):
        chunk = queries[lo:lo + batch]
        n = len(chunk)
        chunk = np.pad(chunk, ((0, batch - n), (0, 0)))
        out.append(encode_queries(model, chunk)[0][:n])
    return torch.cat(out)


@pytest.fixture(scope="module")
def cpu_model():
    return init_colbert(CFG, seed=3, device="cpu")


# ------------------------------------------------------------------ CPU

def test_cpu_model_takes_the_eager_path(cpu_model):
    with torch.no_grad():
        assert query_graph_blockers(cpu_model) == ["the model is on cpu"]
    assert query_graph_blockers(init_colbert(CFG, device="meta"))[0] == \
        "the model is on meta"


def test_grad_mode_on_is_a_blocker(cpu_model):
    with torch.enable_grad():
        assert "grad mode is on" in query_graph_blockers(cpu_model)
    with torch.no_grad():
        assert "grad mode is on" not in query_graph_blockers(cpu_model)


def test_sharding_context_is_a_blocker(cpu_model):
    with torch.no_grad():
        with mesh_context(object(), {}):
            assert "a sharding context is active" in \
                query_graph_blockers(cpu_model)
        assert "a sharding context is active" not in \
            query_graph_blockers(cpu_model)


def test_dtensor_parameter_is_a_blocker():
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch import mesh as t_mesh
    model = init_colbert(CFG, seed=1, device="cpu")
    with t_mesh.process_group("cpu"):
        mesh = t_mesh.make_mesh((1,), ("data",), "cpu")
        model.proj.w = nn.Parameter(distribute_tensor(
            model.proj.w.detach(), mesh, [Replicate()]))
        with torch.no_grad():
            why = query_graph_blockers(model)
    assert "a parameter is a DTensor" in why


@pytest.mark.parametrize("width", WIDTHS)
def test_searcher_equals_encode_queries_on_the_cpu(cpu_model, width):
    q = _queries(9, width, seed=width)
    s = Searcher(cpu_model, None, encode_batch=4)
    with counting() as c:
        got = s.encode_queries(q)
    assert torch.equal(got, _eager(cpu_model, q, 4))
    assert c == {"search.encode_chunks": 3}      # replays 0, captures 0
    assert not s._graphs


@pytest.mark.parametrize("width", WIDTHS)
def test_staged_ids_are_the_chunk_tokens(cpu_model, width):
    """The graph's input, padded on the host, becomes the chunk's own
    tokens in ``prepare_query_tokens``, and its eager encode gives the
    eager path's vectors."""
    q = _queries(5, width, seed=10 + width)
    g = QueryGraph(cpu_model, 8)
    staged = g.stage(q)
    assert staged.shape == (8, BODY) and staged.dtype == np.int32
    assert (staged[5:] == PAD_ID).all()
    ids = torch.from_numpy(staged.copy())
    want, _ = prepare_query_tokens(torch.as_tensor(q), CFG.query_maxlen)
    assert torch.equal(prepare_query_tokens(ids, CFG.query_maxlen)[0][:5],
                       want)
    with torch.no_grad():
        assert torch.equal(g.encode_ids(ids)[:5], _eager(cpu_model, q, 8))


# ------------------------------------------------------------------ card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph is captured only on the card")
    return torch.device("cuda")


def _card_model(dev, cfg=CFG, seed=5):
    return init_colbert(cfg, seed=seed, device=dev)


@pytest.mark.cuda
def test_graph_equals_eager_bitwise(dev):
    model = _card_model(dev)
    s = Searcher(model, None, encode_batch=16)
    batches = [_queries(16, BODY, seed=i) for i in range(3)]
    batches += [_queries(7, BODY, seed=3), _queries(16, 11, seed=4),
                _queries(37, BODY + 3, seed=5)]
    with counting() as c:
        for q in batches:
            got = s.encode_queries(q)
            assert torch.equal(got, _eager(model, q, 16))
    assert c["search.encode_chunks"] == c["search.encode_replays"] == 8
    assert c["search.encode_captures"] == 1


@pytest.mark.cuda
def test_graph_equals_eager_at_jacolbertv2_width(dev):
    cfg = rt.JA_CONFIG
    model = _card_model(dev, cfg)
    s = Searcher(model, None, encode_batch=256)
    for seed in range(2):
        q = _queries(256, cfg.query_maxlen - 2, seed=seed,
                     vocab=cfg.trunk.vocab_size)
        got = s.encode_queries(q)
        want = _eager(model, q, 256)
        assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
def test_a_result_outlives_the_next_replay(dev):
    model = _card_model(dev)
    s = Searcher(model, None, encode_batch=16)
    a = s.encode_queries(_queries(16, BODY, seed=1))
    a0 = a.clone()
    b = s.encode_queries(_queries(16, BODY, seed=2))
    torch.cuda.synchronize()
    assert torch.equal(a, a0) and not torch.equal(a, b)


@pytest.mark.cuda
def test_in_place_weight_change_is_seen_without_a_capture(dev):
    model = _card_model(dev)
    s = Searcher(model, None, encode_batch=16)
    q = _queries(16, BODY, seed=6)
    with counting() as c:
        before = s.encode_queries(q)
        with torch.no_grad():
            model.trunk.embed.table.mul_(-1.5)
            model.proj.w.add_(0.1)
        after = s.encode_queries(q)
    assert not torch.equal(before, after)
    assert torch.equal(after, _eager(model, q, 16))
    assert c["search.encode_captures"] == 1


@pytest.mark.cuda
def test_replaced_parameter_is_captured_anew(dev):
    model = _card_model(dev)
    s = Searcher(model, None, encode_batch=16)
    q = _queries(16, BODY, seed=7)
    with counting() as c:
        s.encode_queries(q)
        model.proj.w = nn.Parameter(model.proj.w.detach() * 0.5 + 0.01)
        got = s.encode_queries(q)
    assert torch.equal(got, _eager(model, q, 16))
    assert c["search.encode_captures"] == 2
    assert c["search.encode_replays"] == 2


@pytest.mark.cuda
def test_two_threads_replaying_get_the_eager_results(dev):
    model = _card_model(dev)
    s = Searcher(model, None, encode_batch=16)
    qs = [_queries(16, BODY, seed=20 + t) for t in range(2)]
    want = [_eager(model, q, 16) for q in qs]
    s.encode_queries(qs[0])                     # captured here
    bad, errors = [], []

    def run(t):
        try:
            for _ in range(50):
                got = s.encode_queries(qs[t])
                if not torch.equal(got, want[t]):
                    bad.append(t)
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not bad

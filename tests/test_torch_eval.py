"""The port's eval subsystem (``repro_torch/eval``, ``retrieval/metrics``,
``retrieval/evaluate``, ``Retriever.evaluate``) against the JAX
package's, at SMOKE size with the same seeded weights
(``params_from_jax``) and the same tokens.

* ``compute_metrics`` and the integer cores (``ranked_gains``,
  ``first_hit_ranks``) against the JAX package's metrics and the numpy
  reference (``retrieval/metrics.py``) on 8 seeds and the edge cases of
  ``tests/test_eval_metrics.py``: gains and ranks exact, values within
  1e-6 (f32 sums against the reference's f64 loop).
* ``load_beir`` on a BEIR-layout directory written to ``tmp_path``.
* ``QualitySweep`` against the JAX ``QualitySweep`` on the same grid:
  flat cells have equal vector counts and index bytes, rankings equal
  tie-aware (1e-5) and metrics within 1e-6; plaid cells (each package
  trains its codec on its own vectors, and a residual on a cutoff can
  flip a bucket, as ``tests/test_torch_slice.py`` bounds; the centroids
  come from each package's own seeded draws) have equal counts and bytes
  and metrics within ``PLAID_METRIC_ATOL``.
* The report's JSON and markdown round trip (equal to the reference's
  rendering), the gate passing and then tripping on an injected loss,
  the deprecated shim, and ``Retriever.evaluate``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import repro
import repro_torch as rt
from repro.eval import QualitySweep as JSweep
from repro.eval import metrics as JM
from repro.eval import report as JR
from repro.eval import synthetic_dataset as j_synthetic
from repro.retrieval import metrics as R
from repro_torch import eval as E
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.eval import metrics as M
from repro_torch.retrieval import metrics as TR

METRICS = ("ndcg@10", "recall@5", "success@5", "mrr@10")
GRID = dict(methods=("ward", "sequential"), factors=(1, 2),
            backends=("flat", "plaid"), quant_bits=(2,), metrics=METRICS,
            encode_batch=16)
# plaid cells: each package trains its centroids from its own seeded
# draws (torch's generator, JAX's PRNG), so the 2-bit reconstructions and
# the rankings they give differ; at 12 queries one query moves
# success@5 by 0.083, and this grid differs by up to 0.167 (two queries)
PLAID_METRIC_ATOL = 0.25
REFERENCE = {"ndcg": R.ndcg_at_k, "recall": R.recall_at_k,
             "success": R.success_at_k, "mrr": R.mrr_at_k}


def _random_case(rng, n_queries, n_docs, k, graded=True):
    ranked = np.stack([rng.permutation(n_docs)[:k]
                       for _ in range(n_queries)]).astype(np.int64)
    qrels = []
    for _ in range(n_queries):
        n = int(rng.integers(0, min(6, n_docs) + 1))
        docs = rng.permutation(n_docs)[:n]
        hi = 4 if graded else 2
        qrels.append({int(d): int(rng.integers(0, hi)) for d in docs})
    return ranked, qrels


def _held(ranked, qrels, k):
    """The port against the JAX package and the numpy reference."""
    np.testing.assert_array_equal(M.ranked_gains(ranked, qrels, "cpu"),
                                  JM.ranked_gains(ranked, qrels))
    np.testing.assert_array_equal(
        M.first_hit_ranks(ranked, qrels, k, "cpu"),
        JM.first_hit_ranks(ranked, qrels, k))
    names = [f"{b}@{k}" for b in M.METRIC_NAMES]
    got = M.compute_metrics(ranked, qrels, names, device="cpu")
    want = JM.compute_metrics(ranked, qrels, names)
    as_lists = [list(map(int, row)) for row in ranked]
    for name in names:
        base = name.split("@")[0]
        assert got[name] == pytest.approx(want[name], abs=1e-6), name
        assert got[name] == pytest.approx(REFERENCE[base](as_lists, qrels,
                                                          k), abs=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_metrics_match_jax_and_reference(seed):
    rng = np.random.default_rng(seed)
    n_docs = int(rng.integers(5, 60))
    k = int(rng.integers(1, 15))
    ranked, qrels = _random_case(rng, int(rng.integers(1, 12)), n_docs,
                                 min(k, n_docs), graded=bool(seed % 2))
    _held(ranked, qrels, k)


@pytest.mark.parametrize("case", ["empty qrels", "all irrelevant",
                                  "outside top k", "pads", "graded",
                                  "ties"])
def test_metric_edge_cases(case):
    """The edge cases of ``tests/test_eval_metrics.py``, each held to
    the JAX package and the numpy reference, plus the reference test's
    own expected values."""
    if case == "empty qrels":
        ranked, qrels, k = np.array([[0, 1, 2], [2, 1, 0]]), [{}, {2: 1}], 3
        for name in M.DEFAULT_METRICS:
            assert M.metric_fn(name)(ranked, [{}, {}], "cpu") == 0.0
        assert M.ndcg_at_k(ranked, qrels, 3, "cpu") == pytest.approx(1.0)
    elif case == "all irrelevant":
        ranked, qrels, k = np.array([[0, 1], [0, 1]]), [{0: 0, 1: 0},
                                                        {0: 1}], 2
        assert M.success_at_k(ranked, qrels, 2, "cpu") == pytest.approx(0.5)
        assert M.recall_at_k(ranked, qrels, 2, "cpu") == pytest.approx(1.0)
        assert M.ndcg_at_k(ranked, qrels, 2, "cpu") == pytest.approx(0.5)
    elif case == "outside top k":
        ranked, qrels, k = np.array([[3, 4, 5, 6, 7, 8, 9, 10, 11, 0]]), \
            [{0: 3}], 10
        assert M.success_at_k(ranked, qrels, 5, "cpu") == 0.0
        assert M.mrr_at_k(ranked, qrels, 10, "cpu") == pytest.approx(0.1)
        assert M.first_hit_ranks(ranked, qrels, 5, "cpu")[0] == 0
        assert M.first_hit_ranks(ranked, qrels, 10, "cpu")[0] == 10
    elif case == "pads":
        ranked, qrels, k = np.array([[1, 0, -1, -1, -1]]), [{0: 2, 1: 1}], 5
        np.testing.assert_array_equal(M.ranked_gains(ranked, qrels, "cpu"),
                                      [[1, 2, 0, 0, 0]])
    elif case == "graded":
        ranked, qrels, k = np.array([[7, 8]]), [{7: 3, 8: 1}], 2
        assert M.ndcg_at_k(ranked, qrels, 2, "cpu") == pytest.approx(1.0)
        assert M.ndcg_at_k(ranked[:, ::-1], qrels, 2, "cpu") < 1.0
    else:
        ranked, qrels, k = np.array([[5, 6, 1]]), [{5: 2, 6: 2}], 3
        assert M.first_hit_ranks(ranked, qrels, 3, "cpu")[0] == 1
    _held(ranked, qrels, k)


def test_metric_names_packing_and_registry():
    q = M.PaddedQrels.from_dicts([{3: 2, 5: 1}, {}, {0: 0}])
    j = JM.PaddedQrels.from_dicts([{3: 2, 5: 1}, {}, {0: 0}])
    for f in ("ids", "gains", "judged"):
        np.testing.assert_array_equal(getattr(q, f), getattr(j, f))
    np.testing.assert_array_equal(q.has_positive, j.has_positive)
    assert M.PaddedQrels.from_dicts([{}]).ids.shape == (1, 1)
    assert M.parse_metric("ndcg@10") == ("ndcg", 10)
    for bad in ("ndcg", "ndcg@0", "nope@10", "ndcg@x", "ndcg@10@2"):
        with pytest.raises(ValueError):
            M.parse_metric(bad)
    assert M.max_k(("ndcg@10", "recall@5", "mrr@12")) == 12
    np.testing.assert_array_equal(M.rankings_matrix([[2, 0], [1]], 4),
                                  JM.rankings_matrix([[2, 0], [1]], 4))
    # the numpy reference is a plain copy: same registry, same values
    ranked, qrels = [[0, 1, 2, 3, 4]], [{1: 2, 4: 1}]
    assert set(TR.METRICS) == set(R.METRICS)
    for name, ref in R.METRICS.items():
        assert TR.METRICS[name](ranked, qrels) == ref(ranked, qrels)
        assert M.metric_fn(name)(np.array(ranked), qrels, "cpu") == \
            pytest.approx(ref(ranked, qrels), abs=1e-6)
    assert E.__all__ == repro.eval.__all__


def test_load_beir_directory_layout(tmp_path):
    from repro.eval import load_beir as j_load_beir
    (tmp_path / "qrels").mkdir()
    with open(tmp_path / "corpus.jsonl", "w") as fh:
        for i in range(5):
            fh.write(json.dumps({"_id": f"d{i}", "title": f"title {i}",
                                 "text": f"document body {i} alpha"})
                     + "\n")
    with open(tmp_path / "queries.jsonl", "w") as fh:
        fh.write(json.dumps({"_id": "q1", "text": "alpha one"}) + "\n")
        fh.write(json.dumps({"_id": "q2", "text": "beta two"}) + "\n")
        fh.write(json.dumps({"_id": "q3", "text": "unjudged"}) + "\n")
    with open(tmp_path / "qrels" / "test.tsv", "w") as fh:
        fh.write("query-id\tcorpus-id\tscore\n")
        fh.write("q1\td0\t2\nq1\td3\t1\nq2\td4\t1\n")
    ds = E.load_beir(str(tmp_path), doc_maxlen=16, query_maxlen=8)
    jds = j_load_beir(str(tmp_path), doc_maxlen=16, query_maxlen=8)
    assert ds.n_docs == 5 and ds.n_queries == 2     # q3 dropped
    assert ds.qrels == jds.qrels == [{0: 2, 3: 1}, {4: 1}]
    np.testing.assert_array_equal(ds.doc_tokens, jds.doc_tokens)
    np.testing.assert_array_equal(ds.query_tokens, jds.query_tokens)
    assert ds.meta == jds.meta
    ds3 = E.load_beir(str(tmp_path), doc_maxlen=16, query_maxlen=8,
                      max_docs=4)
    assert ds3.n_docs == 4 and ds3.n_queries == 1
    assert ds3.qrels[0] == {0: 2, 3: 1}
    with pytest.raises(FileNotFoundError):
        E.load_beir(str(tmp_path / "none"), 16, 8)


# ---------------------------------------------------------------------------
# The sweep, both packages on one grid
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    from repro.configs.colbertv2 import SMOKE as J_SMOKE
    from repro.models import colbert as jcol
    from repro_torch.models import colbert as tcol
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(0), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    kw = dict(vocab_size=tcfg.trunk.vocab_size,
              doc_maxlen=tcfg.doc_maxlen - 2,
              query_maxlen=tcfg.query_maxlen - 2, n_docs=48, n_queries=12,
              seed=3)
    return params, jcfg, model, E.synthetic_dataset("sweep-test", **kw), \
        j_synthetic("sweep-test", **kw)


@pytest.fixture(scope="module")
def reports(setup):
    params, jcfg, model, ds, jds = setup
    return (E.QualitySweep(model, ds, device="cpu", **GRID).run(),
            JSweep(params, jcfg, jds, **GRID).run())


def test_datasets_equal_reference(setup):
    _, _, _, ds, jds = setup
    np.testing.assert_array_equal(ds.doc_tokens, jds.doc_tokens)
    np.testing.assert_array_equal(ds.query_tokens, jds.query_tokens)
    assert ds.qrels == jds.qrels and ds.meta == jds.meta
    pq = ds.padded_qrels()
    np.testing.assert_array_equal(pq.ids, jds.padded_qrels().ids)


@pytest.mark.parametrize("backend", ["flat", "plaid"])
def test_sweep_matches_jax_sweep(reports, backend):
    """Every cell of the grid against the JAX sweep's: counts and bytes
    equal, factor-1 cells exactly 100.0, metrics within 1e-6 (flat) or
    ``PLAID_METRIC_ATOL`` (plaid)."""
    rep, jrep = reports
    qb = 2 if backend == "plaid" else None
    atol = 1e-6 if backend == "flat" else PLAID_METRIC_ATOL
    base, jbase = rep.baseline(backend, qb), jrep.baseline(backend, qb)
    assert (base.n_vectors, base.index_bytes) == (jbase.n_vectors,
                                                  jbase.index_bytes)
    for method in GRID["methods"]:
        for f in GRID["factors"]:
            c, jc = rep.cell(backend, method, f, qb), \
                jrep.cell(backend, method, f, qb)
            assert (c.n_vectors, c.index_bytes, c.shared_baseline) == (
                jc.n_vectors, jc.index_bytes, jc.shared_baseline)
            assert c.vector_reduction == pytest.approx(jc.vector_reduction,
                                                       abs=1e-12)
            for name in METRICS:
                assert c.metrics[name] == pytest.approx(
                    jc.metrics[name], abs=atol), (method, f, name)
            if f == 1:
                assert c.metrics == base.metrics
                assert all(v == 100.0 for v in c.relative.values())


def test_flat_rankings_tie_aware(setup):
    """The flat cells' rankings behind those metrics, built through both
    facades from the same tokens: ids equal tie-aware, scores to 1e-5."""
    params, jcfg, model, ds, _ = setup
    for method, f in (("none", 1), ("ward", 2), ("sequential", 2)):
        spec = rt.RetrieverSpec(
            pooling=rt.PoolingSpec(method=method, factor=f),
            index=rt.IndexSpec.from_config(model.cfg, backend="flat"))
        r = rt.Retriever.build(model, ds.doc_tokens, spec, encode_batch=16,
                               device="cpu")
        jr = repro.Retriever.build(
            params, jcfg, ds.doc_tokens,
            repro.RetrieverSpec.from_dict(spec.to_dict()), encode_batch=16)
        S, I = r.search(ds.query_tokens, k=10)
        jS, jI = jr.search(ds.query_tokens, k=10)
        assert tie_aware_mismatches(np.asarray(jI), np.asarray(jS), I, S,
                                    1e-5) == 0
        np.testing.assert_allclose(S, np.asarray(jS), rtol=1e-5, atol=1e-5)


def test_report_round_trips_json_and_table(reports, tmp_path):
    rep, _ = reports
    back = E.QualityReport.from_json(json.loads(json.dumps(rep.to_json())))
    assert back.to_json() == rep.to_json()
    jback = JR.QualityReport.from_json(rep.to_json())
    for args in ((), ("ndcg@10", "flat"), ("recall@5", "plaid", 2)):
        assert rep.markdown_table(*args) == jback.markdown_table(*args)
    assert rep.summary() == jback.summary()
    assert "| ward | 100.00 |" in rep.markdown_table("ndcg@10", "flat")
    path = str(tmp_path / "quality.json")
    E.write_bench_section(path, "other", {"x": 1})
    E.write_bench_section(path, "quality_sweep", rep)
    got = E.read_bench_section(path, "quality_sweep")
    assert got.to_json() == rep.to_json()
    assert E.read_bench_section(path, "other") == {"x": 1}
    with pytest.raises(KeyError):
        E.read_bench_section(path, "nope")
    assert E.BENCH_QUALITY_FILE == JR.BENCH_QUALITY_FILE


def test_gate_passes_then_trips_on_injected_loss(reports, tmp_path):
    rep, _ = reports
    path = str(tmp_path / "pin.json")
    E.write_bench_section(path, "quality_sweep", rep)
    reg = E.check_regression(rep, rep)
    assert reg.ok and reg.checked > 0
    bad = E.QualityReport.from_json(rep.to_json())
    cell = bad.cell("flat", "ward", 2)
    cell.relative["ndcg@10"] = 10.0
    env = E.check_envelope(bad, min_relative=95.0)
    assert not env.ok and any("envelope" in f for f in env.failures)
    reg = E.check_regression(bad, rep, tolerance=3.0)
    assert not reg.ok and any("regression" in f for f in reg.failures)
    both = E.run_gate(bad, baseline_path=path, envelope={})
    assert not both.ok and any("regression" in f for f in both.failures)
    cell.relative["ndcg@10"] = \
        rep.cell("flat", "ward", 2).relative["ndcg@10"] - 1.0
    assert E.check_regression(bad, rep, tolerance=3.0).ok
    other = E.QualityReport(dataset="x", n_docs=1, n_queries=1, k=10)
    assert not E.check_regression(other, rep).ok
    assert not E.check_envelope(other).ok
    assert E.PAPER_ENVELOPE == repro.eval.PAPER_ENVELOPE
    assert E.relative_performance(0.3, 0.3) == 100.0


def test_deprecated_shim_matches_sweep(setup, reports):
    _, _, model, _, _ = setup
    rep, _ = reports
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    from repro_torch.retrieval.evaluate import evaluate_pooling
    corpus = SyntheticRetrievalCorpus(
        DatasetSpec(name="sweep-test", seed=3, n_docs=48, n_queries=12),
        vocab_size=model.cfg.trunk.vocab_size)
    with pytest.deprecated_call():
        out = evaluate_pooling(model, corpus, methods=("ward",),
                               factors=(2,), backend="flat",
                               metric_name="ndcg@10", device="cpu")
    assert out.baseline_metric == pytest.approx(
        rep.baseline("flat").metrics["ndcg@10"], abs=1e-12)
    assert out.cell("ward", 2).relative == pytest.approx(
        rep.cell("flat", "ward", 2).relative["ndcg@10"], abs=1e-9)
    assert "baseline" in out.table()


def test_retriever_evaluate(setup):
    """One batched search at depth max(k, metric ks), then the metrics:
    equal to the JAX ``Retriever.evaluate`` and to the numpy reference
    on the port's own rankings."""
    params, jcfg, model, ds, jds = setup
    spec = rt.RetrieverSpec(
        pooling=rt.PoolingSpec(method="ward", factor=2),
        index=rt.IndexSpec.from_config(model.cfg, backend="flat"))
    r = rt.Retriever.build(model, ds.doc_tokens, spec, encode_batch=16,
                           device="cpu")
    jr = repro.Retriever.build(params, jcfg, jds.doc_tokens,
                               repro.RetrieverSpec.from_dict(spec.to_dict()),
                               encode_batch=16)
    names = ("ndcg@10", "mrr@12", "recall@5")
    out = r.evaluate(ds, metrics=names, k=10)
    want = jr.evaluate(jds, metrics=names, k=10)
    assert set(out) == set(names)
    for n in names:
        assert out[n] == pytest.approx(want[n], abs=1e-6)
    ranked = [list(row) for row in r.rankings(ds.query_tokens, k=12)]
    assert out["mrr@12"] == pytest.approx(R.mrr_at_k(ranked, ds.qrels, 12),
                                          abs=1e-6)
    assert out["ndcg@10"] == pytest.approx(
        R.ndcg_at_k(ranked, ds.qrels, 10), abs=1e-6)

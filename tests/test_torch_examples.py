"""The port's four examples (``repro_torch.examples``) on the CPU.

* Each ``main([..., "--device", "cpu"])`` runs to its end and returns
  its figures: quickstart, build_and_search on its default (hnsw) and
  cascade, train_colbert (cut to 4 steps of 4 pairs, its sweep whole),
  multi_arch_smoke over every assigned architecture.
* quickstart and build_and_search run again with the JAX examples'
  weights (``params_from_jax`` of ``init_colbert(PRNGKey(0), SMOKE)``)
  beside the JAX examples themselves (``examples/*.py``, their
  ``Retriever.build`` and ``search`` recorded): the stored vector counts
  equal, and every search the example makes (the build's queries, after
  the add, after the delete) gives ids equal tie-aware with scores
  within 1e-4. Both encoders compute in f32 there (the JAX example's
  ``get_smoke_config`` patched to the f32 trunk): in the SMOKE default,
  bf16, torch and XLA round apart by a few hundredths of a score.
  plaid's codec is trained by each package on its own vectors, so plaid
  is held by its counts alone.
  The cascade backend raises at the delete, as the JAX example does.
"""
import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest

import repro
import repro_torch as rt
from repro.configs import get_smoke_config as j_smoke
from repro.models.colbert import init_colbert as j_init
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.examples import (build_and_search, multi_arch_smoke,
                                  quickstart, train_colbert)
from repro_torch.models.colbert import ColBERT, params_from_jax

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
SCORE_TOL = 1e-4
CPU = ["--device", "cpu"]


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(monkeypatch, cls):
    """Wrap ``cls.build`` and ``cls.search``: -> (the stats of each
    build as it returned, (scores, ids) of every search, in order)."""
    built, searches = [], []
    build, search = cls.build.__func__, cls.search

    def rec_build(klass, *a, **kw):
        r = build(klass, *a, **kw)
        built.append(r.stats)
        return r

    def rec_search(self, *a, **kw):
        out = search(self, *a, **kw)
        searches.append((np.asarray(out[0]), np.asarray(out[1])))
        return out

    monkeypatch.setattr(cls, "build", classmethod(rec_build))
    monkeypatch.setattr(cls, "search", rec_search)
    return built, searches


def _f32(cfg):
    return dataclasses.replace(cfg, trunk=dataclasses.replace(
        cfg.trunk, dtype="float32"))


@pytest.fixture(scope="module")
def jax_model():
    """The port's SMOKE ColBERT in f32 with the JAX example's weights."""
    params = j_init(jax.random.PRNGKey(0), _f32(j_smoke("colbertv2")))
    return ColBERT(_f32(rt.get_smoke_config("colbertv2")), device="cpu"
                   ).load_params(params_from_jax(
                       jax.tree_util.tree_map(np.asarray, params)))


@pytest.fixture
def jax_example_f32(monkeypatch):
    """The JAX examples' ``repro.get_smoke_config`` in f32."""
    monkeypatch.setattr(repro, "get_smoke_config",
                        lambda arch: _f32(j_smoke(arch)))


def _agree(jS, jI, S, I):
    assert I.shape == jI.shape
    assert tie_aware_mismatches(jI, jS, I, S, SCORE_TOL) == 0
    np.testing.assert_allclose(S, jS, rtol=0, atol=SCORE_TOL)


def test_quickstart_runs():
    out = quickstart.main(CPU)
    rows = out["rows"]
    assert rows["ward f=2"]["vectors"] < rows["unpooled"]["vectors"]
    assert 0.4 < out["vector_reduction"] < 0.55
    assert all(0.0 <= r["ndcg@10"] <= 1.0 for r in rows.values())


def test_quickstart_against_jax_example(jax_model, jax_example_f32,
                                       monkeypatch):
    jbuilt, _ = _record(monkeypatch, repro.Retriever)
    built, _ = _record(monkeypatch, rt.Retriever)
    assert _jax_example("quickstart").main() == 0
    out = quickstart.main(CPU, model=jax_model)
    assert len(built) == len(jbuilt) == 2
    for st, jst in zip(built, jbuilt):
        assert st.n_vectors_stored == jst.n_vectors_stored
        assert st.n_vectors_raw == jst.n_vectors_raw
    assert [out["rows"][k]["vectors"] for k in ("unpooled", "ward f=2")] \
        == [jst.n_vectors_stored for jst in jbuilt]


@pytest.mark.parametrize("flags", [[], ["--backend", "cascade"]])
def test_build_and_search_runs(flags):
    if flags:                       # as the JAX example: no delete there
        with pytest.raises(NotImplementedError, match="delete"):
            build_and_search.main(flags + CPU)
        return
    out = build_and_search.main(CPU)        # hnsw, the default
    assert out["n_docs"] == 100 and out["added"] == [100, 119]
    assert out["victim"] not in out["after_delete"][1][0].tolist()


@pytest.mark.parametrize("backend", ["flat", "hnsw", "plaid"])
def test_build_and_search_against_jax_example(jax_model, jax_example_f32,
                                              monkeypatch, backend):
    jbuilt, jsearches = _record(monkeypatch, repro.Retriever)
    built, searches = _record(monkeypatch, rt.Retriever)
    assert _jax_example("build_and_search").main(
        ["--backend", backend]) == 0
    out = build_and_search.main(["--backend", backend] + CPU,
                                model=jax_model)
    assert out["vectors"] == built[0].n_vectors_stored == \
        jbuilt[0].n_vectors_stored
    assert out["n_docs"] == jbuilt[0].n_docs
    assert len(searches) == len(jsearches) == 2
    if backend != "plaid":
        for (S, I), (jS, jI) in zip(searches, jsearches):
            _agree(jS, jI, S, I)


def test_train_colbert_runs(tmp_path):
    out = train_colbert.main(["--steps", "4", "--batch", "4",
                              "--checkpoint-dir", str(tmp_path)] + CPU)
    assert out["final_step"] == 4
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    cells = out["report"]["cells"]
    assert sorted(c["factor"] for c in cells) == [1, 2, 3, 4]
    again = train_colbert.main(["--steps", "6", "--batch", "4", "--resume",
                                "--checkpoint-dir", str(tmp_path)] + CPU)
    assert again["final_step"] == 6


def test_multi_arch_smoke_runs():
    losses = multi_arch_smoke.main(CPU)
    assert list(losses) == list(rt.ASSIGNED_ARCHS)
    assert np.isfinite(list(losses.values())).all()

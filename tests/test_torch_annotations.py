"""The port's sharding annotations, site for site with the JAX package's.

A recorder replaces the ``constrain`` name each model module imported,
in both packages (the reference's models, ``repro.core.maxsim``; the
port's counterparts), and keeps the logical-axis names of every call;
it returns its input, so neither package lays anything out (the
reference's ``with_sharding_constraint`` is never called). One small
step per family runs in both packages, the reference's traced
(``jax.make_jaxpr``, its compile caches cleared first so every jitted
function traces again) at one layer a stack, one block and one logits
chunk, since a scan traces its body once, and the two sequences of name
tuples must be equal:
the LM's forward, loss, prefill and decode (a dense trunk and a MoE
trunk, capacity dispatch), one MoE layer, ColBERT's encode and search,
DimeNet, and the four recsys models' forward and candidate scoring.
Together these reach all 40 of the reference's sites.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.maxsim as j_maxsim
import repro.models.attention as j_attention
import repro.models.colbert as j_colbert
import repro.models.gnn.dimenet as j_dimenet
import repro.models.mlp as j_mlp
import repro.models.moe as j_moe
import repro.models.recsys.embedding as j_embedding
import repro.models.recsys.models as j_recsys
import repro.models.transformer as j_transformer
import repro_torch.core.maxsim as t_maxsim
import repro_torch.models.attention as t_attention
import repro_torch.models.colbert as t_colbert
import repro_torch.models.gnn.dimenet as t_dimenet
import repro_torch.models.mlp as t_mlp
import repro_torch.models.moe as t_moe
import repro_torch.models.recsys.embedding as t_embedding
import repro_torch.models.recsys.models as t_recsys
import repro_torch.models.transformer as t_transformer
from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps as tsteps

J_MODULES = (j_attention, j_transformer, j_mlp, j_moe, j_colbert, j_maxsim,
             j_embedding, j_recsys, j_dimenet)
T_MODULES = (t_attention, t_transformer, t_mlp, t_moe, t_colbert, t_maxsim,
             t_embedding, t_recsys, t_dimenet)
CPU = torch.device("cpu")


@pytest.fixture
def record(monkeypatch):
    """-> (jax calls, port calls): each a list of name tuples, in order."""
    calls = {"jax": [], "torch": []}

    def recorder(which):
        def constrain(x, *names):
            calls[which].append(tuple(names))
            return x
        return constrain

    for mod in J_MODULES:
        monkeypatch.setattr(mod, "constrain", recorder("jax"))
    for mod in T_MODULES:
        monkeypatch.setattr(mod, "constrain", recorder("torch"))
    return calls


def _shapes(init, cfg):
    """The reference's parameter tree as shapes (nothing drawn)."""
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


def _trace(fn, *args):
    """The reference's ``fn(*args)`` traced, not run: every ``constrain``
    call it makes is recorded once."""
    jax.clear_caches()
    jax.make_jaxpr(fn)(*args)


def _same(calls, expect_len=None):
    assert calls["jax"], "the reference recorded nothing"
    assert calls["torch"] == calls["jax"]
    if expect_len is not None:
        assert len(calls["jax"]) == expect_len


def _ints(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


# ------------------------------------------------------------------ LM
LM_ARCHS = ("qwen3-0.6b", "moonshot-v1-16b-a3b")


def _lm(arch):
    """One layer (Moonshot's: a MoE layer)."""
    jc = j_get_smoke(arch)
    tc = get_smoke_config(arch)
    jc = dataclasses.replace(jc, n_layers=1)
    tc = dataclasses.replace(tc, n_layers=1)
    params = _shapes(j_transformer.init_transformer, jc)
    model = t_transformer.init_transformer(tc, seed=0, device=CPU)
    return jc, params, tc, model


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_and_loss_sites(record, arch):
    jc, params, tc, model = _lm(arch)
    tok = _ints((2, 8), jc.vocab_size)
    _trace(lambda p, t: j_transformer.forward(p, t, jc), params, tok)
    _trace(lambda p, t: j_transformer.lm_loss(p, t, t, jc), params, tok)
    with torch.no_grad():
        model(torch.as_tensor(tok))
        t_transformer.lm_loss(model, torch.as_tensor(tok),
                              torch.as_tensor(tok))
    # embed, then per layer attention (5), mlp or moe, the boundary; the
    # loss's trunk again and its one logits chunk
    _same(record)
    assert ("batch", "seq", "vocab") in record["jax"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_sites(record, arch):
    jc, params, tc, model = _lm(arch)
    tok = _ints((2, 8), jc.vocab_size)
    _trace(lambda p, t: jsteps.make_lm_prefill_step(jc)(p, {"tokens": t}),
           params, tok)
    jcache = jax.eval_shape(lambda: j_transformer.init_cache(jc, 2, 8))
    _trace(lambda p, c, t: jsteps.make_lm_decode_step(jc)(
        p, c, {"token": t, "pos": jnp.int32(7)}), params, jcache,
        tok[:, :1])
    _, cache = tsteps.make_lm_prefill_step(tc, device=CPU)(
        model, {"tokens": torch.as_tensor(tok)})
    tsteps.make_lm_decode_step(tc, device=CPU)(
        model, cache, {"token": torch.as_tensor(tok[:, :1]), "pos": 7})
    _same(record)
    assert ("batch", "cacheseq", "kv", None) in record["jax"]
    assert ("batch", "kvseq", "kv", None) in record["jax"]


def test_moe_capacity_layer_sites(record):
    jc = j_get_smoke("moonshot-v1-16b-a3b")
    tc = get_smoke_config("moonshot-v1-16b-a3b")
    p = _shapes(j_moe.init_moe, jc)
    layer = t_moe.MoE(tc)
    x = np.random.default_rng(0).normal(size=(2, 8, jc.d_model)).astype(
        np.float32)
    _trace(lambda p_, x_: j_moe.moe_capacity(p_, x_, jc), p, x)
    with torch.no_grad():
        t_moe.moe_capacity(layer, torch.as_tensor(x), tc)
    _same(record, 4 if jc.gated_mlp else 3)


# ------------------------------------------------------------- ColBERT
def _colbert():
    jc = j_get_smoke("colbertv2")
    tc = get_smoke_config("colbertv2")
    jc = dataclasses.replace(jc, trunk=dataclasses.replace(jc.trunk,
                                                           n_layers=1))
    tc = dataclasses.replace(tc, trunk=dataclasses.replace(tc.trunk,
                                                           n_layers=1))
    params = _shapes(j_colbert.init_colbert, jc)
    model = t_colbert.init_colbert(tc, seed=0, device=CPU)
    return jc, params, tc, model


def test_colbert_encode_sites(record):
    jc, params, tc, model = _colbert()
    tok = _ints((3, 10), 100) + 30
    _trace(lambda p, t: j_colbert.encode_queries(p, t, jc), params, tok)
    _trace(lambda p, t: j_colbert.encode_docs(p, t, jc), params, tok)
    t_colbert.encode_queries(model, torch.as_tensor(tok))
    t_colbert.encode_docs(model, torch.as_tensor(tok))
    _same(record)
    assert record["jax"][-1] == ("batch", "seq", None)


def test_colbert_search_sites(record):
    jc, params, tc, model = _colbert()
    rng = np.random.default_rng(1)
    batch = {"q_tokens": _ints((4, 8), 100) + 30,
             "doc_vecs": rng.normal(size=(16, 12, jc.proj_dim)).astype(
                 np.float32),
             "doc_mask": rng.random((16, 12)) < 0.8}
    _trace(jsteps.make_colbert_search_step(jc, k=5), params, batch)
    with torch.no_grad():
        tsteps.make_colbert_search_step(tc, k=5, device=CPU)(
            model, {k: torch.as_tensor(v) for k, v in batch.items()})
    _same(record)
    assert record["jax"][-2:] == [("queries", None, None),
                                  ("docs", None, None)]


# -------------------------------------------------------------- DimeNet
def test_dimenet_sites(record):
    from test_torch_gnn import molecules
    jc = dataclasses.replace(j_get_smoke("dimenet"), n_blocks=1)
    tc = dataclasses.replace(get_smoke_config("dimenet"), n_blocks=1)
    params = _shapes(j_dimenet.init_dimenet, jc)
    model = t_dimenet.init_dimenet(tc, seed=0, device=CPU)
    inputs, _ = molecules(2, 6, 10, jc.triplet_cap, 0)
    _trace(lambda p, i: j_dimenet.dimenet_forward(p, i, jc, task="graph",
                                                  n_graphs=2),
           params, inputs)
    with torch.no_grad():
        t_dimenet.dimenet_forward(model, inputs, tc, task="graph",
                                  n_graphs=2)
    # 4 before the blocks, 3 a block, 2 after
    _same(record, 6 + 3 * jc.n_blocks)


# --------------------------------------------------------------- recsys
@pytest.mark.parametrize("arch", ("wide-deep", "deepfm", "fm", "dlrm-rm2"))
def test_recsys_sites(record, arch):
    from test_torch_recsys import _batch
    jc = j_get_smoke(arch)
    tc = get_smoke_config(arch)
    params = _shapes(j_recsys.init_recsys, jc)
    model = t_recsys.init_recsys(tc, seed=0, device=CPU)
    batch = _batch(jc, 6, 0, label=False)
    cand = np.random.default_rng(2).normal(size=(20, jc.embed_dim)).astype(
        np.float32)
    _trace(lambda p, b: j_recsys.recsys_forward(p, b, jc), params, batch)
    _trace(lambda p, b, c: j_recsys.score_candidates(p, b, c, jc, k=5),
           params, batch, cand)
    with torch.no_grad():
        t_recsys.recsys_forward(model, batch, tc)
        t_recsys.score_candidates(model, batch, cand, tc, k=5)
    # forward: tables (2), the bags' annotation, wide (2), the logit;
    # scoring: tables (2), candidates, scores
    _same(record, 10)


def test_every_reference_site_is_reached():
    """The 40 sites: each module's ``constrain(`` calls in the reference
    are counted, so a new one there shows here."""
    import inspect
    counts = {m.__name__: inspect.getsource(m).count("constrain(")
              - inspect.getsource(m).count("def constrain(")
              for m in J_MODULES}
    assert sum(counts.values()) == 40, counts

"""The port's ColBERT encoder (``repro_torch.models``) against the JAX
reference (``repro.models.colbert``) on the same parameters and ids.

Tolerances: in f32 both sides run the same arithmetic in another order,
so vectors agree to 1e-5. At the config's bf16, XLA and torch round
intermediate products at different places; unit output vectors then
agree to a cosine of 0.999 (measured worst case ~0.9999 at SMOKE size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.colbertv2 import SMOKE as J_SMOKE
from repro.models import colbert as jcol
from repro_torch.configs.colbertv2 import SMOKE as T_SMOKE
from repro_torch.models import colbert as tcol


def _cfgs(dtype):
    jc = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype=dtype))
    tc = dataclasses.replace(T_SMOKE, trunk=dataclasses.replace(
        T_SMOKE.trunk, dtype=dtype))
    return jc, tc


def _pair(dtype, seed=0):
    jc, tc = _cfgs(dtype)
    params = jcol.init_colbert(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tcol.ColBERT(tc, device="cpu").load_params(
        tcol.params_from_jax(tree))
    return params, jc, model


def _tokens(seed=0, B=5, L=40, lo=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(lo, 1024, size=(B, L)).astype(np.int32)
    lens = rng.integers(3, L, size=B)
    toks[np.arange(L)[None, :] >= lens[:, None]] = 0
    return toks


def test_params_from_jax_round_trip():
    params, _, model = _pair("float32")
    state = tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    layers = params["trunk"]["dense_layers"]
    np.testing.assert_array_equal(
        state["trunk.layers.1.attn.wq.w"],
        np.asarray(layers["attn"]["wq"]["w"])[1])


@pytest.mark.parametrize("kind", ["queries", "docs"])
def test_encode_matches_reference_f32(kind):
    params, jc, model = _pair("float32")
    toks = _tokens(1) if kind == "docs" else _tokens(2, L=6, lo=24)
    jfn = jcol.encode_docs if kind == "docs" else jcol.encode_queries
    tfn = tcol.encode_docs if kind == "docs" else tcol.encode_queries
    jv, jm = jfn(params, jnp.asarray(toks), jc)
    tv, tm = tfn(model, toks)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("kind", ["queries", "docs"])
def test_encode_matches_reference_bf16_cosine(kind):
    params, jc, model = _pair("bfloat16", seed=3)
    toks = _tokens(4) if kind == "docs" else _tokens(5, L=6, lo=24)
    jfn = jcol.encode_docs if kind == "docs" else jcol.encode_queries
    tfn = tcol.encode_docs if kind == "docs" else tcol.encode_queries
    jv, jm = jfn(params, jnp.asarray(toks), jc)
    tv, tm = tfn(model, toks)
    emit = np.asarray(jm)
    np.testing.assert_array_equal(emit, tm.numpy())
    cos = (np.asarray(jv) * tv.numpy()).sum(-1)[emit]
    assert cos.min() > 0.999, cos.min()


def test_emit_masks_and_prepared_tokens_equal():
    toks = _tokens(6)
    toks[:, 3] = 10                       # punctuation ids do not emit
    toks[0, 1] = 8
    for q_len in (8, 3):
        jt, ja = jcol.prepare_query_tokens(jnp.asarray(toks[:, :q_len]), 8)
        tt, ta = tcol.prepare_query_tokens(torch.from_numpy(toks[:, :q_len]),
                                           8)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    jt, ja = jcol.prepare_doc_tokens(jnp.asarray(toks), 48)
    tt, ta = tcol.prepare_doc_tokens(torch.from_numpy(toks), 48)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    for punct in (True, False):
        je = jcol.emit_mask_docs(jt, ja, punct)
        te = tcol.emit_mask_docs(tt, ta, punct)
        np.testing.assert_array_equal(np.asarray(je), te.numpy())
    assert not np.asarray(jcol.emit_mask_docs(jt, ja, True))[:, 5].any()


def test_init_colbert_matches_reference_distributions():
    """Seeded torch init draws the reference initializers' laws:
    truncated normal(0.02) embeddings, normal(1/sqrt(d_in)) weights."""
    model = tcol.init_colbert(T_SMOKE, seed=0, device="cpu")
    table = model.trunk.embed.table.detach()
    assert float(table.abs().max()) <= 0.04 + 1e-6
    assert abs(float(table.std()) - 0.02 * 0.8796) < 1e-3
    w = model.trunk.layers[0].mlp.w1.w.detach()
    assert abs(float(w.std()) - 1 / np.sqrt(64)) < 5e-3
    again = tcol.init_colbert(T_SMOKE, seed=0, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)

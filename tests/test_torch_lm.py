"""The port's causal-LM serving path (``repro_torch.models`` and
``repro_torch.launch.steps``) against the JAX package's at SMOKE sizes,
with the weights carried over by ``params_from_jax`` and the same numpy
token ids: RoPE, RMSNorm, the gated MLP, the three branches of
``attention_forward`` (full, chunked, flash dispatch), ``prefill``'s
hidden states and cache, three ``decode_step``s, and the two step
builders. The flash dispatch runs the JAX package's Pallas kernel in
interpret mode and the port's plain version of its kernel.

Tolerances: f32 (``dtype="float32"``) atol 2e-5, rtol 1e-5 — the same
arithmetic summed in another order over two layers (observed <= 5e-6).
bf16, the configs' own compute dtype: XLA and torch round intermediate
products at different places, so hidden states and logits agree to
atol 0.1 (observed at most 0.035, at values up to 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import steps as jsteps
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import RMSNorm, act_fn
from repro_torch.models.mlp import MLP

ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b", "qwen2.5-14b")
F32 = dict(rtol=1e-5, atol=2e-5)
BF16 = dict(rtol=0.0, atol=0.1)


def _cfgs(arch, dtype="float32", **kw):
    jc = dataclasses.replace(j_get_smoke(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    return jc, tc


def _pair(arch, dtype="float32", seed=0, **kw):
    jc, tc = _cfgs(arch, dtype, **kw)
    params = jtr.init_transformer(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = ttr.TransformerLM(tc, device="cpu").load_params(
        ttr.params_from_jax(tree))
    return params, jc, model, tc


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------------ configs
# The reference's execution and sharding hints, which no ported module
# reads yet; a new reference field fails the test until it is ported or
# listed here.
JAX_ONLY_FIELDS = {"scan_layers", "remat", "logits_chunk", "attn_shard",
                   "optimizer", "fsdp_params", "train_microbatches",
                   "grad_accum_dtype", "unroll_scans"}
# The reference ColbertConfig's doc block of its blocked MaxSim; the port's
# maxsim kernel blocks docs itself (``maxsim_impl`` is read by
# ``make_colbert_search_step``).
COLBERT_JAX_ONLY_FIELDS = {"maxsim_block"}


def _assert_fields_equal(td, jd, jax_only):
    assert set(jd) - set(td) == jax_only
    assert set(td) <= set(jd)
    assert td == {k: jd[k] for k in td}


@pytest.mark.parametrize("arch", PORTED_ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_equal_reference_field_by_field(arch, which):
    if which == "CONFIG":
        j, t = j_get_config(arch), get_config(arch)
    else:
        j, t = j_get_smoke(arch), get_smoke_config(arch)
    if arch == "colbertv2":
        td = {k: v for k, v in dataclasses.asdict(t).items() if k != "trunk"}
        jd = {k: v for k, v in dataclasses.asdict(j).items() if k != "trunk"}
        _assert_fields_equal(td, jd, COLBERT_JAX_ONLY_FIELDS)
        t, j = t.trunk, j.trunk
    _assert_fields_equal(dataclasses.asdict(t), dataclasses.asdict(j),
                         JAX_ONLY_FIELDS)
    assert t.q_per_kv == j.q_per_kv


# ------------------------------------------------------------------- layers
def test_apply_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    pos = np.arange(100, 124)
    for theta in (10_000.0, 1_000_000.0):
        want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tatt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta)
        np.testing.assert_allclose(_t(got), _np(want), **F32)
    # split-half, not interleaved: position 0 is the identity
    got = tatt.apply_rope(torch.from_numpy(x), torch.zeros(24), 1e6)
    np.testing.assert_array_equal(_t(got), x)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6)
    norm = RMSNorm(32, 1e-6)
    norm.scale.data = torch.from_numpy(scale)
    np.testing.assert_allclose(_t(norm(torch.from_numpy(x))), _np(want),
                               **F32)
    xb = torch.from_numpy(x).bfloat16()
    assert norm(xb).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "tanh"])
def test_gated_mlp_matches_reference(act):
    rng = np.random.default_rng(2)
    p = jmlp.init_mlp(jax.random.PRNGKey(3), 16, 24, gated=True)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = jmlp.mlp(p, jnp.asarray(x), act, True)
    m = MLP(16, 24, act, gated=True)
    m.load_state_dict({f"{k}.w": torch.from_numpy(np.array(p[k]["w"]))
                       for k in ("w1", "w2", "w3")})
    np.testing.assert_allclose(_t(m(torch.from_numpy(x))), _np(want), **F32)
    np.testing.assert_allclose(
        _t(act_fn(act)(torch.from_numpy(x))),
        _np(jlayers.act_fn(act)(jnp.asarray(x))), **F32)


# ---------------------------------------------------------------- attention
BRANCHES = {
    # (config changes, sequence length, the port's function that runs)
    "full": ({}, 32, "full_attn"),
    "chunked": ({"attn_full_threshold": 16, "attn_chunk": 16}, 64,
                "chunked_attn"),
    "flash": ({"use_flash_kernel": True}, 64, "flash_attention"),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_attention_forward_branches(arch, branch, monkeypatch):
    changes, S, fn = BRANCHES[branch]
    params, jc, model, tc = _pair(arch, **changes)
    calls = []
    orig = getattr(tatt, fn)
    monkeypatch.setattr(tatt, fn, lambda *a, **k: calls.append(fn)
                        or orig(*a, **k))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                params["dense_layers"]["attn"])
    jy, (jk, jv) = jatt.attention_forward(lp, jnp.asarray(x), jc,
                                          return_kv=True)
    ty, (tk, tv) = tatt.attention_forward(model.layers[0].attn,
                                          torch.from_numpy(x), tc,
                                          return_kv=True)
    assert calls and set(calls) == {fn}
    np.testing.assert_allclose(_t(ty), _np(jy), **F32)
    np.testing.assert_allclose(_t(tk), _np(jk), **F32)
    np.testing.assert_allclose(_t(tv), _np(jv), **F32)


def test_full_attn_causal_offset_and_repeat_kv():
    """q_offset shifts the causal diagonal; _repeat_kv is head-major."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 4, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 6, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, 6, 2, 8)).astype(np.float32)
    jk, jv = jatt._repeat_kv(jnp.asarray(k), 2), jatt._repeat_kv(
        jnp.asarray(v), 2)
    tk, tv = tatt._repeat_kv(torch.from_numpy(k), 2), tatt._repeat_kv(
        torch.from_numpy(v), 2)
    np.testing.assert_array_equal(_t(tk), _np(jk))
    want = jatt._full_attn(jnp.asarray(q), jk, jv, causal=True, q_offset=2)
    got = tatt.full_attn(torch.from_numpy(q), tk, tv, causal=True,
                         q_offset=2)
    np.testing.assert_allclose(_t(got), _np(want), **F32)


# ---------------------------------------------------------- prefill/decode
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps(arch):
    params, jc, model, tc = _pair(arch, seed=1)
    toks = _tokens(jc, (2, 32), 6)
    jh, jcache = jtr.prefill(params, jnp.asarray(toks), jc, max_len=40)
    th, tcache = model.prefill(torch.from_numpy(toks), 40)
    np.testing.assert_allclose(_t(th), _np(jh), **F32)
    assert tcache["k"].shape == (jc.n_layers, 2, 40, jc.n_kv_heads,
                                 jc.d_head)
    for key in ("k", "v"):
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **F32)
        assert not tcache[key][:, :, 32:].any()         # zero-padded
    # the encoder-style forward gives prefill's hidden states
    np.testing.assert_allclose(_t(model(torch.from_numpy(toks))), _np(jh),
                               **F32)
    rng = np.random.default_rng(7)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jtr.decode_step(params, jnp.asarray(tok), jcache,
                                     32 + step, jc)
        tl, tcache = model.decode_step(torch.from_numpy(tok), tcache,
                                       32 + step)
        assert tl.shape == (2, 1, jc.vocab_size)
        np.testing.assert_allclose(_t(tl), _np(jl), **F32)
        for key in ("k", "v"):
            np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]),
                                       **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_match_reference(arch):
    params, jc, model, tc = _pair(arch, seed=2, use_flash_kernel=True)
    toks = _tokens(jc, (2, 64), 8)
    jl, jcache = jsteps.make_lm_prefill_step(jc)(params,
                                                 {"tokens": jnp.asarray(toks)})
    prefill = tsteps.make_lm_prefill_step(tc, device="cpu")
    tl, tcache = prefill(model, {"tokens": toks})
    np.testing.assert_allclose(_t(tl), _np(jl), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **F32)
    # decode needs room in the cache: prefill both to max_len 68
    _, jcache = jtr.prefill(params, jnp.asarray(toks), jc, max_len=68)
    tl, tcache = tsteps.make_lm_prefill_step(tc, max_len=68, device="cpu")(
        model, {"tokens": toks})
    jdecode = jsteps.make_lm_decode_step(jc)
    tdecode = tsteps.make_lm_decode_step(tc, device="cpu")
    tok = tl.argmax(-1)[:, None].numpy().astype(np.int32)
    for pos in (64, 65, 66):
        jl, jcache = jdecode(params, jcache, {"token": jnp.asarray(tok),
                                              "pos": pos})
        tl, tcache = tdecode(model, tcache, {"token": tok, "pos": pos})
        assert tl.shape == (2, jc.vocab_size)
        np.testing.assert_allclose(_t(tl), _np(jl), **F32)
        tok = tl.argmax(-1)[:, None].numpy().astype(np.int32)
    np.testing.assert_allclose(_t(tcache["v"]), _np(jcache["v"]), **F32)


def test_prefill_bf16_matches_reference_loosely():
    """The configs' own bf16 compute dtype, flash dispatch on."""
    params, jc, model, tc = _pair("qwen3-0.6b", dtype="bfloat16", seed=3,
                                  use_flash_kernel=True)
    toks = _tokens(jc, (2, 64), 9)
    jl, jcache = jsteps.make_lm_prefill_step(jc)(params,
                                                 {"tokens": jnp.asarray(toks)})
    tl, tcache = tsteps.make_lm_prefill_step(tc, device="cpu")(
        model, {"tokens": toks})
    assert tcache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_t(tl), _np(jl), **BF16)
    for key in ("k", "v"):
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **BF16)


# ------------------------------------------------------------ init, params
def test_params_from_jax_round_trip():
    params, jc, model, _ = _pair("qwen2.5-14b")
    state = ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    assert "layers.1.attn.wq.b" in state and "lm_head.w" in state
    np.testing.assert_array_equal(
        state["layers.1.mlp.w3.w"],
        np.asarray(params["dense_layers"]["mlp"]["w3"]["w"])[1])
    _, _, q3, _ = _pair("qwen3-0.6b")
    assert "layers.0.attn.q_norm.scale" in q3.state_dict()


def test_tied_head_matches_reference():
    params, jc, model, tc = _pair("qwen3-0.6b", tie_embeddings=True)
    assert model.lm_head is None and "lm_head" not in params
    h = np.random.default_rng(10).normal(size=(2, 3, jc.d_model)).astype(
        np.float32)
    np.testing.assert_allclose(
        _t(model.logits_head(torch.from_numpy(h))),
        _np(jtr.logits_head(params, jnp.asarray(h), jc)), **F32)


def test_init_transformer_seeded_with_reference_laws():
    cfg = get_smoke_config("qwen3-0.6b")
    model = ttr.init_transformer(cfg, seed=0, device="cpu")
    again = ttr.init_transformer(cfg, seed=0, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    table = model.embed.table.detach()
    assert float(table.abs().max()) <= 0.04 + 1e-6
    w = model.lm_head.w.detach()
    assert abs(float(w.std()) - 1 / np.sqrt(cfg.d_model)) < 5e-3
    assert torch.equal(model.layers[0].attn.q_norm.scale.detach(),
                       torch.ones(cfg.d_head))
    other = ttr.init_transformer(cfg, seed=1, device="cpu")
    assert not torch.equal(other.embed.table, model.embed.table)


def test_prefill_rejects_short_max_len_and_counts_no_launch():
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              use_flash_kernel=True)
    model = ttr.init_transformer(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        model.prefill(toks, 4)
    before = launch_counts()["flash_attention"]
    model.prefill(toks)
    assert launch_counts()["flash_attention"] == before

"""The port's recsys models (``repro_torch.models.recsys``,
``repro_torch.launch.steps`` ``make_recsys_*``) against the JAX
package's at the SMOKE sizes of wide-deep, deepfm, fm and dlrm-rm2
(5-6 fields of 100 rows), the weights carried over by
``params_from_jax`` and the same numpy inputs.

Integer-equal: ``score_candidates``' top-k ids, compared tie-aware
(ids may differ only between candidates whose scores agree within 1e-6
in f32, 0.02 in bf16, where XLA on the CPU keeps the product in f32),
and equal to a full stable sort of the port's own scores. Floats,
tolerances in f32: bags exact up to summation order (rtol 1e-6 / atol
1e-6); logits and the loss rtol 1e-5 / atol 1e-5; gradients rtol 1e-4 / atol 1e-6; three
train steps' losses rtol 1e-5 and parameters rtol 1e-4 / atol 1e-6 on
all but 0.1% of a tensor's elements, which stay within lr / 10 (AdamW's
first steps on gradients of a few eps). In the configs' own bf16:
logits within atol 0.05. A dlrm-rm2 checkpoint written by either
package restores in the other bit for bit and trains on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import steps as jsteps
from repro.models.recsys import embedding as jemb
from repro.models.recsys import models as jrec
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.launch import steps as tsteps
from repro_torch.models.recsys import embedding as temb
from repro_torch.models.recsys import models as trec
from repro_torch.train import CheckpointManager
from repro_torch.train.params import (load_tree, param_groups, to_tree,
                                      tree_paths, value_and_grad)
from repro_torch.train.trainer import load_state_tree, state_to_tree

ARCHS = ("wide-deep", "deepfm", "fm", "dlrm-rm2")
OUT = dict(rtol=1e-5, atol=1e-5)
BAG = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _pair(arch, seed=0, dtype="float32", **kw):
    jc = dataclasses.replace(j_get_smoke(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    params = jrec.init_recsys(jax.random.PRNGKey(seed), jc)
    model = trec.Recsys(tc, device="cpu").load_params(
        trec.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jc, model, tc


def _batch(cfg, B, seed, label=True):
    rng = np.random.default_rng(seed)
    b = {"sparse_ids": np.stack(
        [rng.integers(0, v, (B, cfg.multi_hot)) for v in cfg.vocab_sizes],
        axis=1).astype(np.int32)}
    if cfg.n_dense:
        b["dense"] = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    if label:
        b["label"] = (rng.random(B) < 0.3).astype(np.float32)
    return b


def _j(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


def _close(got_tree, want_tree, **tol):
    got = dict(tree_paths(got_tree))
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == [p for p, _ in want]
    for path, w in want:
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _close_step(got_tree, want_tree, lr):
    got = dict(tree_paths(got_tree))
    for path, w in tree_paths(jax.tree_util.tree_map(np.asarray,
                                                     want_tree)):
        d = np.abs(got[path] - w)
        off = d > GRAD["atol"] + GRAD["rtol"] * np.abs(w)
        assert off.mean() <= 1e-3 and d.max() <= lr / 10, (
            path, int(off.sum()), float(d.max()))


# ---------------------------------------------------------- embeddings
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_embedding_bag_matches_reference(mode, dtype):
    """Multi-hot bags of 3 over 4 fields; bf16: the gathered rows cast
    (the reference casts the table first: the same values)."""
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(4, 50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 4, 3)).astype(np.int32)
    want = jemb.embedding_bag({"tables": jnp.asarray(tables)},
                              jnp.asarray(ids), mode=mode,
                              dtype=None if dtype is None else jnp.bfloat16)
    got = temb.embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids),
                             mode=mode, dtype=None if dtype is None
                             else torch.bfloat16)
    assert tuple(got.shape) == (6, 4, 8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(BAG if dtype is None
                                  else dict(rtol=1e-2, atol=1e-2)))


def test_cast_after_gather_is_bit_equal():
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.normal(size=(3, 40, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, (5, 3, 1)))
    got = temb.embedding_bag(t, ids, dtype=torch.bfloat16)
    flat = t.to(torch.bfloat16).reshape(-1, 8)
    want = flat[ids[..., 0] + torch.arange(3) * 40]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fields", [False, True])
def test_embedding_bag_ragged_matches_reference(fields):
    rng = np.random.default_rng(2)
    tables = rng.normal(size=(3, 30, 4)).astype(np.float32)
    flat_ids = rng.integers(0, 30, 40).astype(np.int32)
    seg = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    fids = rng.integers(0, 3, 40).astype(np.int32) if fields else None
    want = jemb.embedding_bag_ragged(
        {"tables": jnp.asarray(tables)}, jnp.asarray(flat_ids),
        jnp.asarray(seg), 10, None if fids is None else jnp.asarray(fids))
    got = temb.embedding_bag_ragged(
        torch.from_numpy(tables), torch.from_numpy(flat_ids),
        torch.from_numpy(seg), 10,
        None if fids is None else torch.from_numpy(fids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG)


def test_fm_second_order_trick():
    """The sum-square identity against the reference and the explicit
    pairwise sum."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(7, 5, 6)).astype(np.float32)
    got = trec._fm_second_order(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jrec._fm_second_order(jnp.asarray(emb))), **OUT)
    pairs = sum((emb[:, i] * emb[:, j]).sum(-1) for i in range(5)
                for j in range(i + 1, 5))
    np.testing.assert_allclose(got, pairs, rtol=1e-4, atol=1e-4)


def test_dot_interaction_matches_reference():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(3, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        trec._dot_interaction(torch.from_numpy(v)).numpy(),
        np.asarray(jrec._dot_interaction(jnp.asarray(v))), **OUT)


# --------------------------------------------------- forward, loss, grads
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    params, jc, model, tc = _pair(arch, seed=5)
    b = _batch(jc, 16, seed=6)
    want = jrec.recsys_forward(params, _j(b), jc)
    with torch.no_grad():
        got = trec.recsys_forward(model, b)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)
    (jl, jm), jg = jax.value_and_grad(jrec.recsys_loss, has_aux=True)(
        params, _j(b), jc)
    loss, m, grads = value_and_grad(lambda mod, bb: trec.recsys_loss(mod, bb),
                                    model, b)
    np.testing.assert_allclose(float(loss), float(jl), **OUT)
    np.testing.assert_allclose(float(m["auc_proxy"]), float(jm["auc_proxy"]))
    _close(to_tree(grads), jg, **GRAD)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference_loosely(arch):
    params, jc, model, tc = _pair(arch, seed=7, dtype="bfloat16")
    b = _batch(jc, 32, seed=8, label=False)
    want = jrec.recsys_forward(params, _j(b), jc)
    with torch.no_grad():
        got = tsteps.make_recsys_serve_step(tc, device="cpu")(model, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0.05)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "fm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_candidates_matches_reference_tie_aware(arch, dtype):
    """Top-50 of 5,000 candidates. f32: ids tie-aware within 1e-6,
    scores to 1e-6. bf16: the port rounds the bags, the user vector and
    the scores to bf16 as the reference's graph says, while XLA on the
    CPU keeps the product in f32; so ids tie-aware within 0.02 and
    scores to 0.02 (a few bf16 steps at scores ~1), and the port's ids
    equal a full stable sort of its own scores (many exact ties, broken
    to the lower candidate id as ``lax.top_k`` does)."""
    params, jc, model, tc = _pair(arch, seed=9, dtype=dtype)
    b = _batch(jc, 2, seed=10, label=False)
    cand = np.random.default_rng(11).normal(
        size=(5000, jc.embed_dim)).astype(np.float32)
    js, ji = jrec.score_candidates(params, _j(b), jnp.asarray(cand), jc,
                                   k=50)
    ts, ti = tsteps.make_recsys_retrieval_step(tc, k=50, device="cpu")(
        model, dict(b, candidates=cand))
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = ts.numpy(), ti.numpy()
    tol = 1e-6 if dtype == "float32" else 0.02
    assert tie_aware_mismatches(ji, js, ti, ts, tol) == 0
    np.testing.assert_allclose(ts, js, rtol=0, atol=tol)
    with torch.no_grad():
        ids = torch.from_numpy(b["sparse_ids"])
        user = temb.embedding_bag(model.tables, ids,
                                  dtype=getattr(torch, dtype)).mean(1)
        full = (user @ torch.from_numpy(cand).to(user.dtype).T).float()
    order = np.argsort(-full.numpy(), axis=1, kind="stable")[:, :50]
    np.testing.assert_array_equal(ti, order)


# ------------------------------------------------------- train, ckpts
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    params, jc, model, tc = _pair(arch, seed=12)
    jstep, jopt = jsteps.make_recsys_train_step(jc, lr=1e-3)
    jstep = jax.jit(jstep)
    step, opt = tsteps.make_recsys_train_step(tc, lr=1e-3, device="cpu")
    jp, js, state = params, jopt.init(params), opt.init(model)
    for s in range(3):
        b = _batch(jc, 32, seed=13 + s)
        jp, js, jout = jstep(jp, js, _j(b))
        state, out = step(model, state, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(out[k]), float(jout[k]),
                                       rtol=1e-5)
    _close_step(to_tree(param_groups(model)), jp, 1e-3)


def test_dlrm_checkpoints_cross_packages(tmp_path):
    """dlrm-rm2 (the MLP lists under ``bot_mlp`` / ``top_mlp``) with its
    AdamW state: the port's checkpoint restored by the reference, which
    trains on; the reference's restored by the port bit for bit, which
    trains on and matches the reference's next step."""
    params, jc, model, tc = _pair("dlrm-rm2", seed=20)
    b = [_batch(jc, 16, seed=21 + s) for s in range(3)]
    jstep, jopt = jsteps.make_recsys_train_step(jc, lr=1e-3)
    jstep = jax.jit(jstep)
    step, opt = tsteps.make_recsys_train_step(tc, lr=1e-3, device="cpu")
    state, _ = step(model, opt.init(model), b[0])
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        1, {"params": to_tree(param_groups(model)),
            "opt_state": state_to_tree(state)})
    _, tree, _ = JCheckpointManager(str(tmp_path / "port")).restore()
    assert isinstance(tree["params"]["bot_mlp"], list)
    jp = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    js = jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])
    _close(to_tree(param_groups(model)), jp, rtol=0, atol=0)
    jp, js, _ = jstep(jp, js, _j(b[1]))
    JCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        2, {"params": jp, "opt_state": js})
    _, _, fresh, _ = _pair("dlrm-rm2", seed=22)
    _, tree, _ = CheckpointManager(str(tmp_path / "jax")).restore()
    groups = param_groups(fresh)
    load_tree(groups, tree["params"])
    state2 = load_state_tree(opt.init(fresh), tree["opt_state"])
    assert state2["step"] == 2
    _close(to_tree(groups), jp, rtol=0, atol=0)
    _close(state_to_tree(state2), js, rtol=0, atol=0)
    _, out = step(fresh, state2, b[2])
    jp, _, jout = jstep(jp, js, _j(b[2]))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    _close_step(to_tree(param_groups(fresh)), jp, 1e-3)


def test_params_round_trip_and_seeded_init():
    for arch in ARCHS:
        params, jc, model, tc = _pair(arch, seed=30)
        _close(trec.params_to_jax(model.state_dict()), params, rtol=0,
               atol=0)
    tc = get_smoke_config("dlrm-rm2")
    a = trec.init_recsys(tc, seed=0, device="cpu")
    b = trec.init_recsys(tc, seed=0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    t = a.tables.detach()
    assert float(t.abs().max()) <= 2 * tc.embed_dim ** -0.5 + 1e-6
    np.testing.assert_allclose(float(t.std()), 0.88 * tc.embed_dim ** -0.5,
                               rtol=0.05)

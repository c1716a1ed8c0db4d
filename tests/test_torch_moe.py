"""The port's MoE (``repro_torch.models.moe``) and MoE trunks
(``repro_torch.models.transformer``, ``repro_torch.launch.steps``)
against the JAX package's at the SMOKE sizes of kimi-k2 (8 experts top
2, GQA 8 / 2) and moonshot (4 experts top 2), in f32, the weights carried
over by ``params_from_jax`` and the same numpy inputs.

Integer-equal: the router's top-k ids, ``_positions_in_expert``, the
keep masks and slots (at the default capacity, a tight capacity that
drops and one with ties in the router). Floats, tolerances: the router
weights and aux rtol 1e-5 / atol 1e-6; MoE layer outputs, hidden states,
logits and caches rtol 1e-5 / atol 2e-5 (the same f32 sums in another
order; observed <= 6e-6); the loss rtol 1e-5; gradients against
``jax.grad`` rtol 1e-4 / atol 1e-6; a train step's parameters as
``tests/test_torch_lm_train.py``'s ``_close_step``. Checkpoints of a MoE
trunk (AdamW on moonshot, Adafactor on kimi-k2, whose config names it)
written by either package restore in the other bit for bit and train
on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.train import CheckpointManager
from repro_torch.train.params import (load_tree, param_groups, to_tree,
                                      tree_paths, value_and_grad)
from repro_torch.train.trainer import load_state_tree, state_to_tree

ARCHS = ("kimi-k2-1t-a32b", "moonshot-v1-16b-a3b")
F32 = dict(rtol=1e-5, atol=2e-5)
SMALL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _cfgs(arch, **kw):
    jc = dataclasses.replace(j_get_smoke(arch), dtype="float32", **kw)
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    return jc, tc


def _pair(arch, seed=0, **kw):
    jc, tc = _cfgs(arch, **kw)
    params = jtr.init_transformer(jax.random.PRNGKey(seed), jc)
    model = ttr.TransformerLM(tc, device="cpu").load_params(
        ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jc, model, tc


def _layer(arch, seed=0, **kw):
    """One MoE layer's reference params and the port's module."""
    jc, tc = _cfgs(arch, **kw)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jc)
    m = tmoe.MoE(tc)
    state = {"router.w": p["router"]["w"], "w1": p["w1"], "w2": p["w2"],
             "w3": p["w3"]}
    for k in ("shared_w1", "shared_w2", "shared_w3"):
        if k in p:
            state[f"{k}.w"] = p[k]["w"]
    m.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in state.items()})
    return p, jc, m.requires_grad_(False), tc


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got_tree, want_tree, **tol):
    got = dict(tree_paths(got_tree))
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == [p for p, _ in want]
    for path, w in want:
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    p, jc, m, tc = _layer(arch, seed=1)
    x = _x((64, jc.d_model), 2)
    jw, jids, jaux = jmoe._router(p, jnp.asarray(x), jc)
    tw, tids, taux = tmoe._router(m, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(_t(tw), _np(jw), **SMALL)
    np.testing.assert_allclose(float(taux), float(jaux), **SMALL)


def test_router_ties_go_to_the_lower_expert():
    """Equal router logits (a zero router): the top-k is experts 0..k-1,
    as ``lax.top_k`` gives, with equal weights."""
    p, jc, m, tc = _layer("kimi-k2-1t-a32b")
    with torch.no_grad():
        m.router.w.zero_()
    p = dict(p, router={"w": jnp.zeros_like(p["router"]["w"])})
    x = _x((8, jc.d_model), 3)
    _, jids, _ = jmoe._router(p, jnp.asarray(x), jc)
    tw, tids, _ = tmoe._router(m, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tids.numpy(), np.tile(
        np.arange(tc.top_k), (8, 1)))
    np.testing.assert_allclose(_t(tw), 1.0 / tc.top_k, rtol=1e-6)


# --------------------------------------------------------------- dispatch
@pytest.mark.parametrize("n_experts,n,seed", [(8, 200, 0), (4, 37, 1),
                                              (64, 3000, 2), (1, 9, 3)])
def test_positions_in_expert_integer_equal(n_experts, n, seed):
    ids = np.random.default_rng(seed).integers(0, n_experts, n).astype(
        np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), n_experts))
    got = tmoe._positions_in_expert(torch.from_numpy(ids).long(), n_experts)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,T,capacity", [
    ("kimi-k2-1t-a32b", 64, None),          # the default: max(8, 20) = 20
    ("kimi-k2-1t-a32b", 64, 8),             # tight: drops
    ("moonshot-v1-16b-a3b", 48, 9),         # tight: drops
    ("moonshot-v1-16b-a3b", 10, None)])     # the floor of 8
def test_keep_masks_and_slots_integer_equal(arch, T, capacity):
    """The reference's keep and slot (``moe_capacity``'s own formulas
    over its router and ``_positions_in_expert``) against ``dispatch``."""
    p, jc, m, tc = _layer(arch, seed=4)
    x = _x((T, jc.d_model), 5)
    _, jids, _ = jmoe._router(p, jnp.asarray(x), jc)
    C = capacity or int(max(8, round(T * jc.top_k / jc.n_experts
                                     * jc.capacity_factor)))
    assert C == (capacity or tmoe.capacity_for(T, tc))
    ids_flat = jids.reshape(-1)
    pos = jmoe._positions_in_expert(ids_flat, jc.n_experts)
    jkeep = np.asarray(pos < C)
    jslot = np.asarray(jnp.where(pos < C, ids_flat * C + pos,
                                 jc.n_experts * C))
    _, tids, _ = tmoe._router(m, torch.from_numpy(x), tc)
    keep, slot = tmoe.dispatch(tids, tc.n_experts, C)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    if capacity is not None:
        assert not jkeep.all()           # the tight cases drop


def test_capacity_is_python_round_half_even():
    cfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                              n_experts=16, top_k=2, capacity_factor=1.0)
    # T * k / E = 8.5 and 9.5: round half to even gives 8 and 10
    assert tmoe.capacity_for(68, cfg) == 8
    assert tmoe.capacity_for(76, cfg) == 10


# ------------------------------------------------------------ the MoE FFN
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,capacity", [("dense", None),
                                           ("capacity", None),
                                           ("capacity", 6),
                                           ("ep", None)])
def test_moe_layer_matches_reference(arch, impl, capacity):
    p, jc, m, tc = _layer(arch, seed=6)
    x = _x((2, 24, jc.d_model), 7)
    if impl == "capacity" and capacity:
        jy, jaux = jmoe.moe_capacity(p, jnp.asarray(x), jc, capacity)
        ty, taux = tmoe.moe_capacity(m, torch.from_numpy(x), tc, capacity)
    else:
        jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jc, impl=impl)
        ty, taux = tmoe.moe_apply(m, torch.from_numpy(x), tc, impl=impl)
    np.testing.assert_allclose(_t(ty), _np(jy), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **SMALL)


def test_shared_experts_match_reference():
    p, jc, m, tc = _layer("moonshot-v1-16b-a3b", seed=8, n_shared_experts=2)
    assert m.shared_w3 is not None
    x = _x((2, 16, jc.d_model), 9)
    for impl in ("dense", "capacity"):
        jy, _ = jmoe.moe_apply(p, jnp.asarray(x), jc, impl=impl)
        ty, _ = tmoe.moe_apply(m, torch.from_numpy(x), tc, impl=impl)
        np.testing.assert_allclose(_t(ty), _np(jy), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_dense_when_roomy(arch):
    """At capacity T * k nothing drops: the capacity path is the dense
    oracle (in the port, and so in the reference)."""
    _, _, m, tc = _layer(arch, seed=10)
    x = torch.from_numpy(_x((2, 32, tc.d_model), 11))
    yd, ad = tmoe.moe_dense(m, x, tc)
    yc, ac = tmoe.moe_capacity(m, x, tc, capacity=64 * tc.top_k)
    np.testing.assert_allclose(_t(yc), _t(yd), **F32)
    assert float(ac) == float(ad)


def test_ep_is_capacity_in_one_process():
    _, _, m, tc = _layer("kimi-k2-1t-a32b", seed=12)
    x = torch.from_numpy(_x((2, 16, tc.d_model), 13))
    ye, ae = tmoe.moe_ep(m, x, tc)
    yc, ac = tmoe.moe_capacity(m, x, tc)
    assert torch.equal(ye, yc) and torch.equal(ae, ac)


# ------------------------------------------------------------- the trunks
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["capacity", "dense"])
def test_forward_and_lm_loss_match_reference(arch, impl):
    params, jc, model, tc = _pair(arch, seed=14)
    toks = _tokens(jc, (2, 32), 15)
    labels = np.roll(toks, -1, 1)
    jh, jaux = jtr.forward(params, jnp.asarray(toks), jc, moe_impl=impl)
    with torch.no_grad():
        th, taux = model(torch.from_numpy(toks), moe_impl=impl,
                         return_aux=True)
    np.testing.assert_allclose(_t(th), _np(jh), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **SMALL)
    assert float(taux) > 0
    jl, jm = jtr.lm_loss(params, jnp.asarray(toks), jnp.asarray(labels), jc,
                         moe_impl=impl)
    tl, tm = ttr.lm_loss(model, torch.from_numpy(toks),
                         torch.from_numpy(labels), moe_impl=impl)
    np.testing.assert_allclose(float(tl), float(jl), **SMALL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **SMALL)
    np.testing.assert_allclose(float(tl), float(tm["xent"] + tm["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    params, jc, model, tc = _pair(arch, seed=16)
    toks = _tokens(jc, (2, 32), 17)
    jh, jcache = jtr.prefill(params, jnp.asarray(toks), jc, max_len=36)
    th, tcache = model.prefill(torch.from_numpy(toks), 36)
    np.testing.assert_allclose(_t(th), _np(jh), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_t(tcache[key]), _np(jcache[key]), **F32)
    rng = np.random.default_rng(18)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jtr.decode_step(params, jnp.asarray(tok), jcache,
                                     32 + step, jc)
        tl, tcache = model.decode_step(torch.from_numpy(tok), tcache,
                                       32 + step)
        np.testing.assert_allclose(_t(tl), _np(jl), **F32)
    np.testing.assert_allclose(_t(tcache["k"]), _np(jcache["k"]), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_pass_moe_impl(arch):
    params, jc, model, tc = _pair(arch, seed=19)
    toks = _tokens(jc, (2, 16), 20)
    for impl in ("dense", None):
        jl, jcache = jsteps.make_lm_prefill_step(jc, moe_impl=impl)(
            params, {"tokens": jnp.asarray(toks)})
        tl, tcache = tsteps.make_lm_prefill_step(tc, impl, device="cpu")(
            model, {"tokens": toks})
        np.testing.assert_allclose(_t(tl), _np(jl), **F32)
        tok = tl.argmax(-1)[:, None].numpy().astype(np.int32)
        _, jcache = jtr.prefill(params, jnp.asarray(toks), jc, max_len=17,
                                moe_impl=impl or "capacity")
        _, tcache = tsteps.make_lm_prefill_step(
            tc, impl, max_len=17, device="cpu")(model, {"tokens": toks})
        jd, _ = jsteps.make_lm_decode_step(jc, moe_impl=impl)(
            params, jcache, {"token": jnp.asarray(tok), "pos": 16})
        td, _ = tsteps.make_lm_decode_step(tc, impl, device="cpu")(
            model, tcache, {"token": tok, "pos": 16})
        np.testing.assert_allclose(_t(td), _np(jd), **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["capacity", "dense"])
def test_gradients_match_reference(arch, impl):
    """Every parameter's gradient (the router's through the combine
    weights and the aux loss) against ``jax.grad``, remat on."""
    params, jc, model, tc = _pair(arch, seed=21, remat=True,
                                  logits_chunk=16)
    toks = _tokens(jc, (2, 32), 22)
    labels = np.roll(toks, -1, 1)

    def jloss(p):
        return jtr.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels), jc,
                           moe_impl=impl)

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, _, grads = value_and_grad(
        lambda m, t, l: ttr.lm_loss(m, t, l, tc, moe_impl=impl), model,
        torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jl), **SMALL)
    _close(to_tree(grads), jg, **GRAD)
    router = to_tree(grads)["moe_layers"]["moe"]["router"]["w"]
    assert np.isfinite(router).all() and np.abs(router).max() > 0


def test_first_dense_layers_trunk_matches_reference():
    """One dense block, then MoE blocks with shared experts: two stacks
    in the tree, forward, loss, cache and the tree both ways."""
    params, jc, model, tc = _pair("moonshot-v1-16b-a3b", seed=23,
                                  n_layers=3, first_dense_layers=1,
                                  n_shared_experts=1)
    assert len(model.layers) == 1 and len(model.moe_layers) == 2
    assert set(params) >= {"dense_layers", "moe_layers"}
    toks = _tokens(jc, (2, 16), 24)
    jh, jaux = jtr.forward(params, jnp.asarray(toks), jc)
    with torch.no_grad():
        th, taux = model(torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(_t(th), _np(jh), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **SMALL)
    _, jcache = jtr.prefill(params, jnp.asarray(toks), jc)
    _, tcache = model.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(_t(tcache["v"]), _np(jcache["v"]), **F32)
    _close(ttr.params_to_jax(model.state_dict()), params, rtol=0, atol=0)


def test_init_transformer_moe_laws():
    tc = get_smoke_config("kimi-k2-1t-a32b")
    model = ttr.init_transformer(tc, seed=0, device="cpu")
    moe = model.moe_layers[0].moe.requires_grad_(False)
    assert moe.router.w.dtype == torch.float32
    assert moe.w1.shape == (tc.n_experts, tc.d_model, tc.moe_d_ff)
    assert moe.w2.shape == (tc.n_experts, tc.moe_d_ff, tc.d_model)
    np.testing.assert_allclose(float(moe.w1.std()), tc.d_model ** -0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(moe.w2.std()), tc.moe_d_ff ** -0.5,
                               rtol=0.05)
    again = ttr.init_transformer(tc, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


# ---------------------------------------------------------- train, ckpts
def _close_step(got_tree, want_tree, lr):
    got = dict(tree_paths(got_tree))
    for path, w in tree_paths(jax.tree_util.tree_map(np.asarray,
                                                     want_tree)):
        d = np.abs(got[path] - w)
        off = d > GRAD["atol"] + GRAD["rtol"] * np.abs(w)
        assert off.mean() <= 1e-3 and d.max() <= lr / 10, (
            path, int(off.sum()), float(d.max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages_and_train_on(arch, tmp_path):
    """A train step of each package from the same weights; the port's
    checkpoint restored by the reference and its next step; the
    reference's checkpoint restored by the port bit for bit and its next
    step (kimi-k2: Adafactor, factored over each stacked [L, E, d, f]
    expert weight's last two dims, the optimizer kimi-k2's config names;
    moonshot: AdamW)."""
    opt = "adafactor" if arch.startswith("kimi") else "adamw"
    assert get_config(arch).optimizer == opt
    kw = dict(logits_chunk=16, train_microbatches=1,
              grad_accum_dtype="float32", optimizer=opt)
    params, jc, model, tc = _pair(arch, seed=25, **kw)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, jc.vocab_size, (3, 2, 33)).astype(np.int32)
    b = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    jstep = jax.jit(jsteps.make_lm_train_step(jc, lr=1e-3)[0])
    step, o = tsteps.make_lm_train_step(tc, lr=1e-3, device="cpu")
    state, out = step(model, o.init(model), b[0])
    jp, js, jout = jstep(params, jsteps.make_lm_train_step(
        jc, lr=1e-3)[1].init(params), jax.tree_util.tree_map(jnp.asarray,
                                                             b[0]))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               **SMALL)
    _close_step(to_tree(param_groups(model)), jp, 1e-3)
    if tc.optimizer == "adafactor":
        vr = state["slots"]["moe_layers/moe/w1"]["vr"]
        assert tuple(vr.shape) == (tc.n_layers, tc.n_experts, tc.d_model)
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        1, {"params": to_tree(param_groups(model)),
            "opt_state": state_to_tree(state)})
    n, tree, _ = JCheckpointManager(str(tmp_path / "port")).restore()
    jp2 = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    js2 = jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])
    assert n == 1 and int(js2["step"]) == 1
    jp2, js2, _ = jstep(jp2, js2, jax.tree_util.tree_map(jnp.asarray, b[1]))
    JCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        2, {"params": jp2, "opt_state": js2})
    _, _, fresh, _ = _pair(arch, seed=27, **kw)
    n, tree, _ = CheckpointManager(str(tmp_path / "jax")).restore()
    groups = param_groups(fresh)
    load_tree(groups, tree["params"])
    state2 = load_state_tree(o.init(fresh), tree["opt_state"])
    assert n == 2 and state2["step"] == 2
    _close(to_tree(groups), jp2, rtol=0, atol=0)
    _close(state_to_tree(state2), js2, rtol=0, atol=0)
    _, out = step(fresh, state2, b[2])
    jp3, _, jout = jstep(jp2, js2, jax.tree_util.tree_map(jnp.asarray, b[2]))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               **SMALL)
    _close_step(to_tree(param_groups(fresh)), jp3, 1e-3)


def test_launch_train_runs_a_moe_trunk(capsys):
    """``--smoke`` routes through the dense oracle, as the reference's
    driver does; the loss is finite."""
    assert ttrain.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--device", "cpu", "--max-retries", "0"]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "finished at step 2" in out
    assert "nan" not in out

"""The port's causal-LM training (``repro_torch.models.transformer``
``lm_loss``, ``repro_torch.launch.steps`` ``make_lm_train_step``,
``repro_torch.launch.train``) against the JAX package's at SMOKE sizes
in f32, the weights carried over by ``params_from_jax`` and the same
numpy token ids.

``lm_loss`` and every parameter's gradient against ``jax.value_and_grad``
of the reference's, with the logits chunked (``logits_chunk`` < S) or
not, ``remat`` on and off, and a loss mask: loss rtol 1e-5, gradients
rtol 1e-4 / atol 1e-6 (two layers' backward summed in another order);
``remat`` on and off give equal gradients bit for bit on the CPU. One
``make_lm_train_step`` update at ``train_microbatches`` 1 and 2 (bf16
accumulator), and with Adafactor (``optimizer="adafactor"``): the loss
and the pre-clip norm rtol 1e-5, the parameters rtol 1e-4 / atol 1e-6
on all but 0.1% of a tensor's elements, which stay within a tenth of
the learning rate (``_close_step``). A trunk's checkpoint ``{"params",
"opt_state"}`` written by either package is restored by the other, bit
for bit, and trained on. ``use_flash_kernel`` has no train step, in
either package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttr
from repro_torch.train import CheckpointManager
from repro_torch.train.params import (param_groups, to_tree, tree_paths,
                                      value_and_grad)
from repro_torch.train.trainer import load_state_tree, state_to_tree

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _pair(arch, seed=0, **kw):
    jc = dataclasses.replace(j_get_smoke(arch), dtype="float32", **kw)
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    params = jtr.init_transformer(jax.random.PRNGKey(seed), jc)
    model = ttr.TransformerLM(tc, device="cpu").load_params(
        ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jc, model, tc


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(got_tree, want_tree, **tol):
    got = dict(tree_paths(got_tree))
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == [p for p, _ in want]
    for path, w in want:
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _close_step(got_tree, want_tree, lr):
    """Parameters after an update: rtol 1e-4 / atol 1e-6, except on at
    most 0.1% of a tensor's elements, which stay within lr / 10. Adam's
    first step moves a parameter by lr * g / (|g| + 1e-8): where |g| is a
    few eps, the two frameworks' 1e-10 gradient differences show."""
    got = dict(tree_paths(got_tree))
    for path, w in tree_paths(jax.tree_util.tree_map(np.asarray,
                                                     want_tree)):
        d = np.abs(got[path] - w)
        off = d > GRAD["atol"] + GRAD["rtol"] * np.abs(w)
        assert off.mean() <= 1e-3 and d.max() <= lr / 10, (
            path, int(off.sum()), float(d.max()))


# qk-norm (qwen3) and QKV bias (qwen2.5) trunks
CASES = [("qwen3-0.6b", False, 32, False), ("qwen3-0.6b", True, 16, True),
         ("qwen2.5-14b", True, 8, False)]


@pytest.mark.parametrize("arch,remat,chunk,masked", CASES)
def test_lm_loss_and_grads_match_reference(arch, remat, chunk, masked):
    params, jc, model, tc = _pair(arch, seed=1, remat=remat,
                                  logits_chunk=chunk)
    b = _batch(jc, 2, 32, seed=2)
    mask = (np.random.default_rng(3).random((2, 32)) < 0.7).astype(
        np.float32) if masked else None

    def jloss(p):
        return jtr.lm_loss(p, jnp.asarray(b["tokens"]),
                           jnp.asarray(b["labels"]), jc,
                           loss_mask=None if mask is None
                           else jnp.asarray(mask))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counted(fn, *a, **k):
        calls.append(fn)
        return orig(fn, *a, **k)

    ttr.checkpoint = counted
    try:
        loss, m, grads = value_and_grad(
            lambda mod, t, l: ttr.lm_loss(
                mod, t, l, tc, None if mask is None
                else torch.from_numpy(mask)),
            model, torch.from_numpy(b["tokens"]),
            torch.from_numpy(b["labels"]))
    finally:
        ttr.checkpoint = orig
    # one checkpoint a logits chunk, and one a block under remat
    assert len(calls) == 32 // chunk + (tc.n_layers if remat else 0)
    np.testing.assert_allclose(float(loss), float(jl), **LOSS)
    for k in ("xent", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS)
    _close(to_tree(grads), jg, **GRAD)
    # without autograd: the same loss, no checkpoint
    with torch.no_grad():
        again, _ = ttr.lm_loss(model, torch.from_numpy(b["tokens"]),
                               torch.from_numpy(b["labels"]), tc,
                               None if mask is None
                               else torch.from_numpy(mask))
    np.testing.assert_allclose(float(again), float(jl), **LOSS)


def test_remat_gives_the_same_gradients():
    _, _, model, tc = _pair("qwen3-0.6b", seed=4)
    b = _batch(tc, 2, 32, seed=5)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        out[remat] = value_and_grad(
            lambda mod, t, l: ttr.lm_loss(mod, t, l, cfg), model,
            torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"]))
    assert torch.equal(out[False][0], out[True][0])
    for a, c in zip(tree_paths(to_tree(out[False][2])),
                    tree_paths(to_tree(out[True][2]))):
        np.testing.assert_array_equal(a[1], c[1], err_msg=a[0])


@pytest.mark.parametrize("micro,acc,opt", [(1, "float32", "adamw"),
                                           (2, "bfloat16", "adamw"),
                                           (1, "float32", "adafactor")])
def test_make_lm_train_step_matches_reference(micro, acc, opt):
    params, jc, model, tc = _pair("qwen3-0.6b", seed=6, logits_chunk=16,
                                  train_microbatches=micro,
                                  grad_accum_dtype=acc, optimizer=opt)
    b = _batch(jc, 4, 32, seed=7)
    jstep, jo = jsteps.make_lm_train_step(jc, lr=1e-3)
    jp, js, jout = jax.jit(jstep)(params, jo.init(params),
                         jax.tree_util.tree_map(jnp.asarray, b))
    step, o = tsteps.make_lm_train_step(tc, lr=1e-3, device="cpu")
    state, out = step(model, o.init(model), b)
    assert state["step"] == int(js["step"]) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), **LOSS)
    _close_step(to_tree(param_groups(model)), jp, 1e-3)
    if opt == "adafactor":
        assert set(state) == {"step", "slots"}
        _close(state_to_tree(state)["slots"], js["slots"], rtol=1e-4,
               atol=1e-12)


def test_train_step_refuses_flash_and_moe():
    """``use_flash_kernel`` has no train step, on a dense or a MoE trunk
    (MoE trunks train since the MoE port: without the flag a step is
    built)."""
    tc = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                             use_flash_kernel=True)
    with pytest.raises(ValueError, match="backward"):
        tsteps.make_lm_train_step(tc, device="cpu")
    moe = dataclasses.replace(get_smoke_config("qwen3-0.6b"), moe=True,
                              n_experts=4, top_k=2)
    with pytest.raises(ValueError, match="backward"):
        tsteps.make_lm_train_step(dataclasses.replace(
            moe, use_flash_kernel=True), device="cpu")
    step, opt = tsteps.make_lm_train_step(moe, device="cpu")
    assert callable(step) and opt.init is not None


def test_trunk_checkpoints_cross_packages(tmp_path):
    """The port's trunk and AdamW state written in the reference's layout
    (layers stacked under ``dense_layers``) and restored by the
    reference, which trains on; its checkpoint restored by the port, bit
    for bit, which trains on and matches the reference's next step."""
    params, jc, model, tc = _pair("qwen2.5-14b", seed=8, logits_chunk=16,
                                  train_microbatches=1)
    b1, b2 = _batch(jc, 2, 32, seed=9), _batch(jc, 2, 32, seed=10)
    step, o = tsteps.make_lm_train_step(tc, lr=1e-3, device="cpu")
    state, _ = step(model, o.init(model), b1)
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        1, {"params": to_tree(param_groups(model)),
            "opt_state": state_to_tree(state)})
    n, tree, _ = JCheckpointManager(str(tmp_path / "port")).restore()
    jp = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    js = jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])
    assert n == 1 and int(js["step"]) == 1
    assert jp["dense_layers"]["attn"]["wq"]["b"].shape[0] == jc.n_layers
    jstep = jax.jit(jsteps.make_lm_train_step(jc, lr=1e-3)[0])
    jp, js, jout = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, b2))
    JCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        2, {"params": jp, "opt_state": js})
    _, _, fresh, _ = _pair("qwen2.5-14b", seed=11, logits_chunk=16)
    n, tree, _ = CheckpointManager(str(tmp_path / "jax")).restore()
    groups = param_groups(fresh)
    from repro_torch.train.params import load_tree
    load_tree(groups, tree["params"])
    state2 = load_state_tree(o.init(fresh), tree["opt_state"])
    assert n == 2 and state2["step"] == 2
    _close(to_tree(groups), jp, rtol=0, atol=0)
    _close(state_to_tree(state2), js, rtol=0, atol=0)
    b3 = _batch(jc, 2, 32, seed=12)
    state3, out = step(fresh, state2, b3)
    jp, js, jout = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, b3))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               **LOSS)
    _close_step(to_tree(param_groups(fresh)), jp, 1e-3)


def test_launch_train_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    base = ["--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--checkpoint-dir", ckpt, "--max-retries", "0"]
    assert ttrain.main(base + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "step 3: loss" in out and "finished at step 3" in out
    assert ttrain.main(base + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "finished at step 5" in out
    assert CheckpointManager(ckpt).all_steps() == [3, 5]

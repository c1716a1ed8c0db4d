"""The port's ColBERT training (``repro_torch.models.colbert``
``colbert_loss``, ``colbert_train_step``; the ``Trainer`` over the
encoder) against the JAX package's at SMOKE size in f32, the weights
carried over by ``params_from_jax`` and the same numpy (query, positive
doc) pairs from the synthetic corpus, as ``examples/train_colbert.py``
builds them.

``colbert_loss``: loss rtol 1e-5, in-batch accuracy equal, every
gradient rtol 1e-4 / atol 1e-5 (the trunk's backward summed in another
order, gradients up to ~2: observed 1.2e-6 at most); the reference's unused ``lm_head`` gets a zero gradient and has
no counterpart. Three ``colbert_train_step``s and a 3-step ``Trainer``
run: the parameters rtol 1e-4 / atol 1e-5 on all but 0.1% of a tensor's
elements, which stay within a tenth of the learning rate (AdamW's
g / (|g| + eps) on gradients a few eps from 0). Checkpoints both ways:
a JAX-written checkpoint restored into the port bit for bit and trained
on, and the port's restored by the reference.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.colbertv2 import SMOKE as J_SMOKE
from repro.models import colbert as jcol
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.colbertv2 import SMOKE as T_SMOKE
from repro_torch.data.corpus import DATASET_SPECS, SyntheticRetrievalCorpus
from repro_torch.models import colbert as tcol
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.optimizer import cosine_schedule, make_optimizer
from repro_torch.train.params import (param_groups, to_tree, tree_paths,
                                      value_and_grad)
from repro_torch.train.trainer import state_to_tree

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
LR = 3e-3


def _pair(seed=0):
    jc = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tc = dataclasses.replace(T_SMOKE, trunk=dataclasses.replace(
        T_SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(seed), jc)
    model = tcol.ColBERT(tc, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jc, model


def _batches(cfg, steps, B=6):
    """``examples/train_colbert.py``'s batches: query ids at
    query_maxlen - 2, the positive docs at min(doc_maxlen - 2, 64)."""
    corpus = SyntheticRetrievalCorpus(DATASET_SPECS["scidocs"],
                                      vocab_size=cfg.trunk.vocab_size)
    qs, ds = corpus.train_pairs(steps * B, seed=1)
    qlen, dlen = cfg.query_maxlen - 2, min(cfg.doc_maxlen - 2, 64)
    out = []
    for s in range(steps):
        q = np.zeros((B, qlen), np.int32)
        d = np.zeros((B, dlen), np.int32)
        for b in range(B):
            qq = qs[s * B + b][:qlen]
            dd = corpus.docs[ds[s * B + b]][:dlen]
            q[b, :len(qq)], d[b, :len(dd)] = qq, dd
        out.append({"q": q, "d": d})
    return out


def _without_head(tree):
    """The reference's tree minus the trunk's unused ``lm_head``."""
    trunk = {k: v for k, v in tree["trunk"].items() if k != "lm_head"}
    return dict(tree, trunk=trunk)


def _close(got_tree, want_tree, **tol):
    got = dict(tree_paths(got_tree))
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == [p for p, _ in want]
    for path, w in want:
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _close_step(got_tree, want_tree):
    got = dict(tree_paths(got_tree))
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == [p for p, _ in want]
    for path, w in want:
        d = np.abs(got[path] - w)
        off = d > GRAD["atol"] + GRAD["rtol"] * np.abs(w)
        assert off.mean() <= 1e-3 and d.max() <= LR / 10, (
            path, int(off.sum()), float(d.max()))


def test_colbert_loss_and_grads_match_reference():
    params, jc, model = _pair()
    b = _batches(jc, 1)[0]
    (jl, jm), jg = jax.value_and_grad(jcol.colbert_loss, has_aux=True)(
        params, jnp.asarray(b["q"]), jnp.asarray(b["d"]), jc)
    loss, m, grads = value_and_grad(tcol.colbert_loss, model, b["q"],
                                    b["d"])
    np.testing.assert_allclose(float(loss), float(jl), **LOSS)
    assert float(m["acc"]) == float(jm["acc"])
    assert not np.asarray(jg["trunk"]["lm_head"]["w"]).any()
    _close(to_tree(grads), _without_head(jg), **GRAD)
    # the public encoders stay without autograd
    qv, _ = tcol.encode_queries(model, b["q"])
    assert not qv.requires_grad


def test_three_train_steps_match_reference():
    params, jc, model = _pair(seed=1)
    opt = make_optimizer("adamw", cosine_schedule(LR, 1, 3))
    jo = jopt.make_optimizer("adamw", jopt.cosine_schedule(LR, 1, 3))
    state, js = opt.init(model), jo.init(params)
    jstep = jax.jit(lambda p, s, q, d: jcol.colbert_train_step(p, s, q, d,
                                                               jc, jo))
    for b in _batches(jc, 3):
        state, m = tcol.colbert_train_step(model, state, b["q"], b["d"], opt)
        params, js, jm = jstep(params, js, jnp.asarray(b["q"]),
                               jnp.asarray(b["d"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert state["step"] == int(js["step"]) == 3
    _close_step(to_tree(param_groups(model)), _without_head(params))


def _loss_fns(jc):
    def jloss(p, b):
        return jcol.colbert_loss(p, b["q"], b["d"], jc)

    def tloss(m, b):
        return tcol.colbert_loss(m, b["q"], b["d"])
    return jloss, tloss


def test_trainer_runs_match_reference():
    params, jc, model = _pair(seed=2)
    batches = _batches(jc, 3)
    jloss, tloss = _loss_fns(jc)
    tc = dict(total_steps=3, lr=LR, warmup=1, log_every=1)
    t = Trainer(tloss, model, TrainConfig(**tc), device="cpu")
    out = t.run(iter(batches))
    jt = JTrainer(jloss, params, JTrainConfig(**tc))
    jout = jt.run(iter(batches))
    for h, jh in zip(out["history"], jout["history"]):
        assert h["step"] == jh["step"]
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4)
    _close_step(to_tree(t.params), _without_head(jt.params))


def test_checkpoints_cross_packages(tmp_path):
    """Two steps in the reference, checkpointed; the port restores them
    (the ``lm_head`` entries ignored) and trains on to step 3, as the
    reference does; the port's checkpoint at 3 is restored by the
    reference."""
    params, jc, model = _pair(seed=3)
    batches = _batches(jc, 3)
    jloss, tloss = _loss_fns(jc)
    tc = dict(total_steps=3, lr=LR, warmup=1, checkpoint_every=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JTrainer(jloss, params, JTrainConfig(checkpoint_dir=jdir, **tc))
    jt.tcfg.total_steps = 2
    jt.run(iter(batches[:2]))
    jt.tcfg.total_steps = 3
    shutil.copytree(jdir, tdir)
    t = Trainer(tloss, model, TrainConfig(checkpoint_dir=tdir, **tc),
                device="cpu")
    assert t.maybe_restore() == 2 and t.opt_state["step"] == 2
    _close(to_tree(t.params), _without_head(jt.params), rtol=0, atol=0)
    _close(state_to_tree(t.opt_state)["m"], _without_head(jt.opt_state["m"]),
           rtol=0, atol=0)
    t.run(iter(batches[2:]))
    jt.run(iter(batches[2:]))
    _close_step(to_tree(t.params), _without_head(jt.params))
    n, tree, _ = JCheckpointManager(tdir).restore()
    assert n == 3 and "lm_head" not in tree["params"]["trunk"]
    j2 = JTrainer(jloss, tree["params"], JTrainConfig(checkpoint_dir=tdir,
                                                      **tc))
    assert j2.maybe_restore() == 3
    _close(tree["opt_state"]["v"], state_to_tree(t.opt_state)["v"],
           rtol=0, atol=0)
    # the reference trains on from the port's checkpoint
    j2.tcfg.total_steps = 4
    out = j2.run(iter(_batches(jc, 4)[3:]))
    assert out["final_step"] == 4 and np.isfinite(out["history"][-1]["loss"])

"""The port's training substrate (``repro_torch.train``,
``repro_torch.data.pipeline``): the reference's ``tests/test_train.py``
cases one for one, then parity with the JAX package.

Ported cases: both optimizers descend, Adafactor's state is factored,
the global-norm clip, the cosine schedule, the checkpoint round trip
with GC, no partial publish, the trainer's restart, the non-finite skip,
the pipeline's determinism, sharding and fast-forward.

Parity (same numpy batches, gradients taken by each framework):
AdamW and Adafactor after 60 steps on the quadratic problem, rtol 1e-4 /
atol 1e-5 (f32 arithmetic in another order: observed <= 1.2e-7); both
on a stacked-layer trunk fed the same gradients, where Adafactor must
factor a stacked [L, d] norm scale and clip over all L layers, as the
reference does (parameters rtol 1e-5 / atol 1e-6, observed <= 1.2e-7;
the moments rtol 1e-4 / atol 1e-9, the clip's norm summed in another
order); the non-finite
skip leaves the optimizer's step where it was; checkpoints written by
either package are restored by the other, bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.data.pipeline import DataPipeline, lm_batches
from repro_torch.train import CheckpointManager, TrainConfig, Trainer
from repro_torch.train.optimizer import (adafactor, clip_by_global_norm,
                                         cosine_schedule, global_norm,
                                         make_optimizer,
                                         optimizer_state_bytes)
from repro_torch.train.params import (param_groups, to_tree, tree_paths,
                                      value_and_grad)
from repro_torch.train.trainer import state_to_tree

QUAD = dict(rtol=1e-4, atol=1e-5)
SAME = dict(rtol=1e-5, atol=1e-6)


class Quad(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(6, 3))
        self.b = nn.Parameter(torch.zeros(3))


def quad_problem():
    model = Quad()
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(6, 3)).astype(np.float32)

    def batch():
        x = rng.normal(size=(16, 6)).astype(np.float32)
        return {"x": x, "y": x @ w_true}

    def loss_fn(m, b):
        x, y = torch.as_tensor(b["x"]), torch.as_tensor(b["y"])
        loss = torch.mean((x @ m.w + m.b - y) ** 2)
        return loss, {"loss": loss}

    return model, batch, loss_fn


def j_quad_loss(p, b):
    l = jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    return l, {"loss": l}


def j_quad_params():
    return {"w": jnp.ones((6, 3)), "b": jnp.zeros((3,))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------- ported one for one
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends(name):
    model, batch, loss_fn = quad_problem()
    opt = make_optimizer(name, 3e-2)
    state = opt.init(model)
    b = batch()
    l0 = float(loss_fn(model, b)[0].detach())
    for _ in range(60):
        l, _, g = value_and_grad(loss_fn, model, b)
        state = opt.update(model, g, state)
    assert float(l) < 0.2 * l0
    assert state["step"] == 60


def test_adafactor_state_is_factored():
    state = adafactor(1e-2).init({"w": torch.ones(64, 32)})
    assert state["slots"]["w"]["vr"].shape == (64,)
    assert state["slots"]["w"]["vc"].shape == (32,)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(gn), 20.0)
    # a bf16 gradient keeps its dtype; a small norm is left alone
    small, gn = clip_by_global_norm({"b": torch.full((4,), 0.25,
                                                     dtype=torch.bfloat16)},
                                    1.0)
    assert small["b"].dtype == torch.bfloat16
    assert float(gn) == 0.5 and torch.equal(small["b"],
                                            torch.full((4,), 0.25).bfloat16())


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100, final_frac=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1, abs=1e-6)
    assert float(lr(55)) > float(lr(90))
    j = jopt.cosine_schedule(1.0, 10, 100, 0.1)
    for s in (0, 3, 10, 11, 37, 55, 99, 100, 150):
        assert lr(s) == pytest.approx(float(j(s)), rel=1e-6, abs=1e-7)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_write=False)
    tree = {"a": {"b": torch.arange(5, dtype=torch.float32)},
            "c": [torch.ones((2, 2)), torch.zeros(3)]}
    for step in (10, 20, 30):
        mgr.save(step, tree, extra={"step": step})
    assert mgr.all_steps() == [20, 30]           # gc kept last 2
    step, restored, extra = mgr.restore()
    assert step == 30 and extra["step"] == 30
    np.testing.assert_array_equal(restored["a"]["b"], np.arange(5))
    assert isinstance(restored["c"], list)
    np.testing.assert_array_equal(restored["c"][0], np.ones((2, 2)))


def test_checkpoint_no_partial_publish(tmp_path):
    """A crashed write (tmp dir left behind) must not count as a
    checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    os.makedirs(tmp_path / "step_99.tmp")
    assert mgr.latest_step() is None
    mgr.save(5, {"x": torch.ones(2)})
    assert mgr.latest_step() == 5


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    """The caller updates its tensors in place right after ``save``: the
    checkpoint holds the values at the call."""
    mgr = CheckpointManager(str(tmp_path))
    t = torch.zeros(1000)
    mgr.save(1, {"t": t})
    t.add_(1.0)
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore()[1]["t"], np.zeros(1000))


def test_trainer_restart_resumes(tmp_path):
    model, batch, loss_fn = quad_problem()

    def batches():
        while True:
            yield batch()

    tc = TrainConfig(total_steps=20, checkpoint_every=10,
                     checkpoint_dir=str(tmp_path), lr=1e-2, log_every=5)
    t1 = Trainer(loss_fn, model, tc, device="cpu")
    out = t1.run(batches())
    assert [h["step"] for h in out["history"]] == [5, 10, 15, 20]
    # a new process restarts from the checkpoint, trains further
    tc2 = TrainConfig(total_steps=30, checkpoint_every=10,
                      checkpoint_dir=str(tmp_path), lr=1e-2)
    fresh, _, _ = quad_problem()
    t2 = Trainer(loss_fn, fresh, tc2, device="cpu")
    assert t2.maybe_restore() == 20
    assert t2.opt_state["step"] == 20
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    out = t2.run(batches())
    assert out["final_step"] == 30


def test_trainer_skips_nonfinite_batch():
    """The poisoned batch's update is skipped: parameters, AdamW's
    moments and its step stay as they were (the reference's
    ``jnp.where`` over both)."""
    model, batch, loss_fn = quad_problem()
    t = Trainer(loss_fn, model, TrainConfig(total_steps=3, lr=1e-2,
                                            skip_nonfinite=True),
                device="cpu")
    bad = batch()
    bad["y"] = np.full_like(bad["y"], np.nan)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t.tcfg.total_steps = 1
    t.run(iter([bad]))
    assert t.step == 1 and t.opt_state["step"] == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert not any(m.any() for m in t.opt_state["m"].values())
    t.tcfg.total_steps = 3
    t.run(iter([batch(), batch()]))
    assert t.opt_state["step"] == 2
    assert torch.isfinite(model.w).all()


def test_trainer_retry_and_roll_back(tmp_path):
    """A step that raises is retried; past ``max_retries`` the trainer
    rolls back to the latest checkpoint once; ``max_retries=0`` raises at
    once."""
    model, batch, loss_fn = quad_problem()
    fails = {"n": 0}

    def flaky(m, b):
        if b.get("fail") is not None and fails["n"] < int(b["fail"]):
            fails["n"] += 1
            raise RuntimeError("transient")
        return loss_fn(m, b)

    def with_fail(n):
        b = batch()
        b["fail"] = np.asarray(n)
        return b

    tc = TrainConfig(total_steps=4, checkpoint_every=2, max_retries=2,
                     checkpoint_dir=str(tmp_path), lr=1e-2, log_every=1)
    t = Trainer(flaky, model, tc, device="cpu")
    out = t.run(iter([batch(), batch(), with_fail(2), batch()]))
    assert out["final_step"] == 4 and fails["n"] == 2     # retried twice
    fails["n"] = 0
    tc.total_steps = 6
    out = t.run(iter([with_fail(3), batch(), batch()]))
    # 3 failures: past max_retries, rolled back to step 4 and retried
    assert fails["n"] == 3 and out["last_good"] == 6
    assert [h["step"] for h in out["history"]] == [5, 6]
    fails["n"] = 0
    t0 = Trainer(flaky, quad_problem()[0],
                 TrainConfig(total_steps=1, max_retries=0,
                             checkpoint_dir=str(tmp_path)), device="cpu")
    with pytest.raises(RuntimeError, match="transient"):
        t0.run(iter([with_fail(1)]))


def test_pipeline_determinism_and_sharding():
    seen = {}
    for shard in (0, 1):
        pipe = DataPipeline(64, 4, lambda ids: {"ids": ids.copy()},
                            seed=3, shard_index=shard, shard_count=2)
        it = pipe.batches()
        seen[shard] = [tuple(next(it)["ids"]) for _ in range(4)]
    # same shard twice -> identical (deterministic restart)
    pipe = DataPipeline(64, 4, lambda ids: {"ids": ids.copy()},
                        seed=3, shard_index=0, shard_count=2)
    it = pipe.batches()
    again = [tuple(next(it)["ids"]) for _ in range(4)]
    assert again == seen[0]
    # shards are disjoint
    flat0 = {i for b in seen[0] for i in b}
    flat1 = {i for b in seen[1] for i in b}
    assert not (flat0 & flat1)


def test_pipeline_fast_forward():
    pipe = DataPipeline(64, 4, lambda ids: {"ids": ids.copy()}, seed=9,
                        shard_index=0, shard_count=1)
    it = pipe.batches()
    batches = [tuple(next(it)["ids"]) for _ in range(6)]
    pipe2 = DataPipeline(64, 4, lambda ids: {"ids": ids.copy()}, seed=9,
                         shard_index=0, shard_count=1)
    it2 = pipe2.batches(start_step=3)
    assert tuple(next(it2)["ids"]) == batches[3]


def test_pipeline_and_lm_batches_match_reference():
    """The same (seed, epoch) permutation and strided slice as the
    reference's, without ``torch.distributed``: rank 0 of 1."""
    from repro.data.pipeline import DataPipeline as JPipe
    from repro.data.pipeline import lm_batches as j_lm_batches
    for shard, count in ((None, None), (1, 3)):
        a = DataPipeline(50, 4, lambda ids: {"ids": ids.copy()}, seed=5,
                         shard_index=shard, shard_count=count).batches()
        b = JPipe(50, 4, lambda ids: {"ids": ids.copy()}, seed=5,
                  shard_index=shard, shard_count=count).batches()
        for _ in range(9):                  # past an epoch's end
            np.testing.assert_array_equal(next(a)["ids"], next(b)["ids"])
    stream = np.random.default_rng(0).integers(0, 100, 8 * 16 * 3 + 1)
    a = lm_batches(stream, 2, 16, seed=1, start_step=2)
    b = j_lm_batches(stream, 2, 16, seed=1, start_step=2)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == np.int32


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_reference_on_quad(name):
    model, batch, loss_fn = quad_problem()
    batches = [batch() for _ in range(60)]
    opt = make_optimizer(name, 3e-2)
    state = opt.init(model)
    jp = j_quad_params()
    jo = jopt.make_optimizer(name, 3e-2)
    js = jo.init(jp)
    for b in batches:
        _, _, g = value_and_grad(loss_fn, model, b)
        state = opt.update(model, g, state)
        _, jg = jax.value_and_grad(j_quad_loss, has_aux=True)(
            jp, jax.tree_util.tree_map(jnp.asarray, b))
        jp, js = jo.update(jp, jg, js)
    for k in ("w", "b"):
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(jp[k]), **QUAD)
    assert state["step"] == int(js["step"]) == 60
    mine, ref = state_to_tree(state), _np(js)
    assert [p for p, _ in tree_paths(mine)] == [p for p, _ in
                                                tree_paths(ref)]
    for (p, a), (_, b) in zip(tree_paths(mine), tree_paths(ref)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6, err_msg=p)


def _trunk():
    """The Qwen3 SMOKE trunk (2 layers) in both layouts: the port's
    module and its reference tree (layers stacked)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_transformer
    model = init_transformer(get_smoke_config("qwen3-0.6b"), seed=0,
                             device="cpu")
    return model, to_tree(param_groups(model))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_reference_on_a_stacked_trunk(name):
    """Three updates from the same gradients (random, in the reference's
    layout). Adafactor's slots follow the stacks: the [L, d] norm scale
    is factored (vr [L], vc [d]) and its update clip spans both layers."""
    model, tree = _trunk()
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32)
        * rng.choice([1e-3, 1.0]), tree) for _ in range(3)]
    opt, jo = make_optimizer(name, 1e-2), jopt.make_optimizer(name, 1e-2)
    state, jp = opt.init(model), jax.tree_util.tree_map(jnp.asarray, tree)
    js, jupdate = jo.init(jp), jax.jit(jo.update)
    groups = param_groups(model)
    for g in grads:
        tg = {p: (list(torch.from_numpy(a)) if isinstance(groups[p], list)
                  else torch.from_numpy(a)) for p, a in tree_paths(g)}
        state = opt.update(model, tg, state)
        jp, js = jupdate(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
    got = dict(tree_paths(to_tree(param_groups(model))))
    for path, want in tree_paths(_np(jp)):
        np.testing.assert_allclose(got[path], want, **SAME, err_msg=path)
    mine = dict(tree_paths(state_to_tree(state)))
    for path, want in tree_paths(_np(js)):
        np.testing.assert_allclose(mine[path], want, rtol=1e-4, atol=1e-9,
                                   err_msg=path)
    if name == "adafactor":
        slot = state["slots"]["dense_layers/attn_norm/scale"]
        assert slot["vr"].shape == (2,) and slot["vc"].shape == (64,)
    assert optimizer_state_bytes(model, name) == sum(
        a.nbytes for p, a in tree_paths(_np(js)) if p != "step")


def test_nonfinite_skip_leaves_the_step_as_the_reference_does():
    model, batch, loss_fn = quad_problem()
    bad = batch()
    bad["y"] = np.full_like(bad["y"], np.nan)
    good = [batch() for _ in range(2)]
    t = Trainer(loss_fn, model, TrainConfig(total_steps=3, lr=1e-2),
                device="cpu")
    t.run(iter([good[0], bad, good[1]]))
    jt = JTrainer(j_quad_loss, j_quad_params(), JTrainConfig(total_steps=3,
                                                             lr=1e-2))
    jt.run(iter([good[0], bad, good[1]]))
    assert t.opt_state["step"] == int(jt.opt_state["step"]) == 2
    for k in ("w", "b"):
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(jt.params[k]), **QUAD)


def _same_tree(a, b):
    pa, pb = tree_paths(_np(a)), tree_paths(_np(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_checkpoints_cross_packages_both_ways(tmp_path):
    """Ten steps in one package, restored by the other's trainer (params,
    AdamW's m, v and step bit for bit), ten more there; and back."""
    model, batch, loss_fn = quad_problem()
    batches = [batch() for _ in range(30)]
    tc = dict(checkpoint_every=10, lr=1e-2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    t = Trainer(loss_fn, model, TrainConfig(total_steps=10,
                                            checkpoint_dir=port_dir, **tc),
                device="cpu")
    t.run(iter(batches[:10]))
    jt = JTrainer(j_quad_loss, j_quad_params(), JTrainConfig(
        total_steps=20, checkpoint_dir=port_dir, **tc))
    assert jt.maybe_restore() == 10
    _same_tree(jt.params, to_tree(param_groups(model)))
    _same_tree(jt.opt_state, state_to_tree(t.opt_state))
    jt.run(iter(batches[10:20]))
    JCheckpointManager(jax_dir, async_write=False).save(
        20, {"params": jt.params, "opt_state": jt.opt_state})
    t2 = Trainer(loss_fn, quad_problem()[0], TrainConfig(
        total_steps=30, checkpoint_dir=jax_dir, **tc), device="cpu")
    assert t2.maybe_restore() == 20 and t2.opt_state["step"] == 20
    _same_tree(to_tree(t2.params), jt.params)
    _same_tree(state_to_tree(t2.opt_state), jt.opt_state)
    t2.run(iter(batches[20:]))
    assert t2.step == 30

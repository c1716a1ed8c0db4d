"""The runs of ``tests/test_torch_train_ranks.py``, and one gloo rank of
its jobs: ``python tests/torch_train_ranks.py JOB OUT_DIR RANK WORLD
STORE``.

Every run trains a SMOKE trunk in f32 from seed 0 through the port's
``Trainer`` (AdamW at lr 1e-3 after 2 warm-up steps; Kimi K2 with its
Adafactor, routed dense as the driver's ``--smoke`` routes, for
``KIMI_STEPS``) on ``STEPS`` global batches of ``B`` x ``S`` tokens in
``MICRO`` microbatches, from ``lm_batches``' stream with
``shard_count=1`` (the same global batch on every rank), a checkpoint
every ``EVERY`` steps.
With a mesh the trainer lays the parameters and its state out by the
reference's rules over the mesh's axes; without one it is the
one-process trainer the test holds the ranks to.

Jobs (each rank writes OUT_DIR/rank<RANK>.npz):

* ``host``: the 1-D host mesh ``("data",)`` of every rank: ``qwen3``
  (checkpoints in OUT_DIR/ckpt; the host arrays of each save's tree
  counted), then ``kimi``;
* ``2x2``: ``qwen3`` over ``make_mesh((2, 2), ("data", "model"))``,
  then ``skip`` (a poisoned batch at step 3 whose loss mask holds a
  NaN: the parameters and the state must stay as they were, bit for
  bit, and the step count too);
* ``fail``: ``qwen3`` on the host mesh with checkpoints in
  OUT_DIR/ckpt, rank 1 raising in its loss at step 4;
* ``resume``: the ``fail`` job's checkpoint (OUT_DIR/ckpt, step 3) on
  this job's ranks, trained on to ``STEPS``; and the same step restored
  through ``CheckpointManager.restore(placements=...)``, each array laid
  out as the trainer's specs say and equal to the file's.

It imports the port only (no JAX).
"""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

CPU = torch.device("cpu")
B, S, MICRO, STEPS, EVERY = 8, 16, 2, 6, 3
KIMI_STEPS = 3                    # Kimi K2 (no checkpoint): half the cost
LR, WARMUP = 1e-3, 2
POISON = 3                        # the skip run's non-finite step
FAIL_AT = 4                       # the fail job's failing step, rank 1
TIMEOUT_S = 60.0                  # the group's timeout


class PlantedFailure(RuntimeError):
    pass


def lm_config(arch):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")


def stream(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size,
                        B * S * (STEPS + 8) + 1).astype(np.int32)


def batches(cfg, start_step=0, poison=None):
    """The global batches from ``start_step``, each with a loss mask of
    ones; at step ``poison`` (1-based) one entry of the mask is NaN."""
    from repro_torch.data.pipeline import lm_batches
    it = lm_batches(stream(cfg), B, S, start_step=start_step, shard_count=1)
    step = start_step
    for b in it:
        step += 1
        mask = np.ones((B, S), np.float32)
        if step == poison:
            mask[B - 1, S - 1] = np.nan
        yield dict(b, mask=mask)


def trainer(arch, mesh=None, ckpt=None, fail_rank=None):
    """A trainer of ``arch``'s SMOKE trunk (seed 0) to ``STEPS`` (Kimi K2
    to ``KIMI_STEPS``), over ``mesh`` with the reference's rules;
    ``fail_rank`` raises in its loss at ``FAIL_AT``."""
    from repro_torch.launch.mesh import batch_axes, fsdp_axes, model_axis
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.sharding.api import lm_rules
    from repro_torch.sharding.params import lm_param_rules
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = lm_config(arch)
    model = init_transformer(cfg, seed=0, device=CPU)
    tcfg = TrainConfig(total_steps=KIMI_STEPS if cfg.moe else STEPS,
                       microbatches=MICRO,
                       checkpoint_every=EVERY, checkpoint_dir=ckpt,
                       max_retries=0, log_every=1, lr=LR, warmup=WARMUP,
                       optimizer=cfg.optimizer)
    state = {}

    def loss_fn(m, b):
        if fail_rank is not None and state["t"].rank == fail_rank and (
                state["t"].step + 1 == FAIL_AT):
            raise PlantedFailure(f"rank {fail_rank} at step {FAIL_AT}")
        return lm_loss(m, b["tokens"], b["labels"], cfg,
                       loss_mask=b["mask"], moe_impl="dense")

    rules = param_rules = None
    if mesh is not None:
        rules = lm_rules(batch_axes(mesh), model_axis(mesh),
                         attn_shard=cfg.attn_shard)
        param_rules = lm_param_rules(fsdp_axes(mesh), model_axis(mesh))
    t = Trainer(loss_fn, model, tcfg, device=CPU, mesh=mesh, rules=rules,
                param_rules=param_rules)
    state["t"] = t
    return t, cfg


def full_tree(t) -> dict:
    """path -> full array of the trainer's parameters and state."""
    from repro_torch.train.params import to_tree, tree_paths
    from repro_torch.train.trainer import state_to_tree
    out = {"params/" + p: a for p, a in tree_paths(to_tree(t.params))}
    out.update({"opt_state/" + p: a for p, a in tree_paths(
        state_to_tree(t.opt_state))})
    return out


def losses(out) -> np.ndarray:
    return np.array([h["loss"] for h in out["history"]], np.float64)


def saved_arrays(t) -> list:
    """The trainer's checkpoint manager's ``save`` wrapped: -> a list
    that gets, at each save, the count of host arrays in the tree this
    rank handed it (the optimizer's step left out)."""
    from repro_torch.train.params import tree_paths
    seen, save = [], t.ckpt.save

    def counted(step, tree, extra=None):
        seen.append(sum(isinstance(a, np.ndarray) for p, a in
                        tree_paths(tree) if p != "opt_state/step"))
        return save(step, tree, extra)
    t.ckpt.save = counted
    return seen


def train(arch, mesh=None, ckpt=None, fail_rank=None) -> dict:
    """-> {"losses", "tree/<path>": full arrays, "saved_arrays" with a
    checkpoint} after the run."""
    t, cfg = trainer(arch, mesh, ckpt, fail_rank)
    seen = saved_arrays(t) if ckpt else None
    out = t.run(batches(cfg))
    res = {"losses": losses(out)}
    if seen is not None:
        res["saved_arrays"] = np.array(seen)
    res.update({"tree/" + k: v for k, v in full_tree(t).items()})
    if mesh is not None:
        res["laid_out"] = np.array(laid_out_as_specs(t, mesh, cfg))
    return res


def laid_out_as_specs(t, mesh, cfg) -> bool:
    """Every parameter and state tensor laid out as the reference's
    specs (``param_specs`` / ``opt_state_specs``) give it on ``mesh``."""
    from repro_torch.launch.mesh import fsdp_axes, model_axis
    from repro_torch.sharding.params import (lm_param_rules,
                                             opt_state_specs, param_specs,
                                             to_placements)
    from repro_torch.train.params import leaves
    p_specs = param_specs(t.params, lm_param_rules(fsdp_axes(mesh),
                                                   model_axis(mesh)))
    want = to_placements(mesh, {
        "params": p_specs, "state": {
            k: v for k, v in opt_state_specs(t.opt_state, p_specs,
                                             cfg.optimizer).items()
            if k != "step"}})
    got = {"params": t.params,
           "state": {k: v for k, v in t.opt_state.items() if k != "step"}}
    placed = [tuple(x.placements) for x in leaves(got)]
    return placed == leaves_of_placements(want)


def leaves_of_placements(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves_of_placements(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_of_placements(v)]
    return [tuple(tree)]


def skip(mesh=None) -> dict:
    """Two steps, the poisoned step (its snapshot before and after, each
    rank's own shards), then on to ``STEPS - 1`` steps."""
    from repro_torch.train.params import leaves
    t, cfg = trainer("qwen3-0.6b", mesh)
    it = batches(cfg, poison=POISON)
    local = [x.to_local() if hasattr(x, "to_local") else x
             for x in leaves({"p": t.params, "s": t.opt_state})
             if torch.is_tensor(x)]
    t.tcfg.total_steps = POISON - 1
    first = t.run(it)
    before = [x.clone() for x in local]
    n_before = t.opt_state["step"]
    t.tcfg.total_steps = POISON
    bad = t.run(it)
    kept = all(torch.equal(a, b) for a, b in zip(before, local))
    t.tcfg.total_steps = STEPS - 1
    rest = t.run(it)
    res = {"losses": np.concatenate([losses(first), losses(bad),
                                     losses(rest)]),
           "kept": np.array(kept and t.step == STEPS - 1
                            and n_before == POISON - 1
                            and t.opt_state["step"] == STEPS - 2)}
    res.update({"tree/" + k: v for k, v in full_tree(t).items()})
    return res


def resume(mesh, ckpt) -> dict:
    """The checkpoint's step 3 on this mesh, trained on to ``STEPS``;
    its ``restore(placements=...)`` against the file."""
    from repro_torch.sharding.params import (checkpoint_placements,
                                             opt_state_specs, param_specs)
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.params import tree_paths
    t, cfg = trainer("qwen3-0.6b", mesh, ckpt)
    start = t.maybe_restore()
    out = t.run(batches(cfg, start_step=start))
    res = {"start": np.array(start), "losses": losses(out)}
    res.update({"tree/" + k: v for k, v in full_tree(t).items()})
    p_specs = param_specs(t.params, t.param_rules)
    place = checkpoint_placements(mesh, p_specs, opt_state_specs(
        t.opt_state, p_specs, cfg.optimizer))
    mgr = CheckpointManager(ckpt)
    _, laid, _ = mgr.restore(start, placements=place, mesh=mesh)
    _, plain, _ = mgr.restore(start)
    plain = dict(tree_paths(plain))
    ok = True
    for path, x in tree_paths(laid):
        if path in place:
            ok &= (tuple(x.placements) == tuple(place[path])
                   and np.array_equal(x.full_tensor().numpy(), plain[path]))
        else:
            ok &= path == "opt_state/step"
    res["restore_laid_out"] = np.array(ok and len(place) == len(plain) - 1)
    return res


def main(job, out_dir, rank, world, store_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                         process_group)
    out = {}
    store = dist.FileStore(store_path, world)
    ckpt = os.path.join(out_dir, "ckpt")
    with process_group("cpu", world_size=world, rank=rank, store=store,
                       timeout=TIMEOUT_S):
        if job == "2x2":
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        else:
            mesh = make_host_mesh("cpu")
        if job == "host":
            runs = {"qwen3": train("qwen3-0.6b", mesh, ckpt),
                    "kimi": train("kimi-k2-1t-a32b", mesh)}
        elif job == "2x2":
            runs = {"qwen3": train("qwen3-0.6b", mesh), "skip": skip(mesh)}
        elif job == "fail":
            runs = {"qwen3": train("qwen3-0.6b", mesh, ckpt, fail_rank=1)}
        else:
            runs = {"resume": resume(mesh, ckpt)}
        for name, res in runs.items():
            for k, v in res.items():
                out[f"{name}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])

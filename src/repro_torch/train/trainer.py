"""Fault-tolerant trainer (``src/repro/train/trainer.py``) over an
``nn.Module``.

``loss_fn(model, batch) -> (loss, metrics)``; the gradient is taken by
autograd (``train/params.py`` ``value_and_grad``) and the optimizer
updates the module's parameters in place.

  * gradient accumulation over microbatches: the batch's leading axis
    split into ``microbatches`` consecutive slices, f32 gradients summed
    and divided by their count; the loss is the mean, the metrics the
    last microbatch's;
  * a non-finite loss skips the update: the parameters and the optimizer
    state, its step included, stay as they were (the reference's
    ``jnp.where`` over both);
  * a step that raises is retried up to ``max_retries`` times, then the
    trainer rolls back to the latest checkpoint once and retries the
    batch there; it raises where there is none, when the batch fails
    again after the roll-back, and at once under ``max_retries=0``
    (fault tolerance off: the reference would roll back and retry the
    same batch without end);
  * periodic and final checkpoints through ``CheckpointManager``, in the
    reference's layout (``{"params", "opt_state"}``, stacks stacked), so
    ``maybe_restore`` resumes from either package's checkpoint.

Batches are host arrays, moved to ``device``: ``cuda`` unless the
caller passes one.

Over a ``DeviceMesh`` (``mesh``; ``rules`` the activations' logical
rules, ``param_rules`` the caller's parameter rules for its model, e.g.
``lm_param_rules`` over the mesh's FSDP and model axes) the parameters
are laid out by ``distribute_params`` under ``param_rules`` and the
optimizer state as they are (``opt.init`` over them); each step runs
in ``rank_context(mesh, rules)``. The host batch is the global batch, the same on every rank:
each microbatch is cut from it on the host (the reference's consecutive
slices of the global rows), then laid out over the batch axes, each
rank taking its own rows (``from_host``).
The loss is the global mean and the clip the full norm, so the
non-finite skip is decided alike on every rank. A step that raises is
not retried: the other ranks would wait in a collective for good, so
every rank stops with the error (within the group's timeout) and a
relaunch on any number of ranks resumes from the latest checkpoint.
Checkpoints gather every leaf on every rank, and rank 0 alone keeps
and writes them; a restore lays each array out as the specs of
``param_rules`` say (``checkpoint_placements``) as it is read. Hooks
run on rank 0.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (Optimizer, cosine_schedule,
                                         make_optimizer)
from repro_torch.train.params import (full_value, load_tree,
                                      microbatch_value_and_grad,
                                      param_groups, to_tree)


@dataclass
class TrainConfig:
    total_steps: int = 100
    microbatches: int = 1             # grad accumulation factor
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    max_retries: int = 2
    log_every: int = 10
    lr: float = 3e-4
    warmup: int = 10
    optimizer: str = "adamw"
    skip_nonfinite: bool = True


def state_to_tree(state: Dict, keep: bool = True) -> Dict:
    """An optimizer state -> the reference's tree (step as int32);
    ``keep`` as ``to_tree``'s."""
    return {k: (np.asarray(v, np.int32) if k == "step" else to_tree(v, keep))
            for k, v in state.items()}


def load_state_tree(state: Dict, tree: Dict) -> Dict:
    """Copy a reference-layout optimizer state into ``state`` in place;
    -> the state with the tree's step."""
    for k, v in state.items():
        if k != "step":
            load_tree(v, tree[k])
    return dict(state, step=int(np.asarray(tree["step"])))


class Trainer:
    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 tcfg: TrainConfig, opt: Optional[Optimizer] = None, *,
                 device: DeviceLike = None, mesh=None,
                 rules: Optional[Dict] = None, param_rules=None):
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.opt = opt or make_optimizer(
            tcfg.optimizer, cosine_schedule(tcfg.lr, tcfg.warmup,
                                            tcfg.total_steps))
        self.model = model
        self.mesh, self.rules = mesh, dict(rules or {})
        self.param_rules = param_rules
        self.rank = 0
        if mesh is not None:
            import torch.distributed as dist
            from repro_torch.sharding.api import P, placements
            from repro_torch.sharding.params import distribute_params
            if param_rules is None:
                raise ValueError("a mesh needs the model's param_rules")
            distribute_params(model, mesh, param_rules)
            self._batch_place = placements(P(self.rules.get("batch")), mesh)
            self.rank = dist.get_rank()
        self.params = param_groups(model)
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       distributed=mesh is not None)
                     if tcfg.checkpoint_dir else None)
        self.loss_fn = loss_fn

    # ------------------------------------------------------------ step fn
    def _place(self, part: Dict[str, torch.Tensor]) -> Dict:
        """A host slice of the global batch -> this rank's rows of it,
        laid out over the batch axes."""
        from repro_torch.sharding.api import from_host
        return {k: from_host(v, self.mesh, self._batch_place, self.device)
                for k, v in part.items()}

    def _step_context(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.sharding.api import rank_context
        return rank_context(self.mesh, self.rules)

    def _train_step(self, batch: Dict[str, torch.Tensor]):
        with self._step_context():
            loss, metrics, grads = microbatch_value_and_grad(
                self.loss_fn, self.model, batch, self.tcfg.microbatches,
                place=None if self.mesh is None else self._place)
            loss = full_value(loss)
            metrics = {k: full_value(v) for k, v in metrics.items()}
            finite = bool(torch.isfinite(loss))
            if finite or not self.tcfg.skip_nonfinite:
                self.opt_state = self.opt.update(self.params, grads,
                                                 self.opt_state)
        return loss, metrics

    # ------------------------------------------------------------ running
    def _placements(self) -> Dict[str, tuple]:
        """path in the checkpoint -> its placements on the mesh."""
        from repro_torch.sharding.params import (checkpoint_placements,
                                                 opt_state_specs,
                                                 param_specs)
        p_specs = param_specs(self.params, self.param_rules)
        kind = "adamw" if "m" in self.opt_state else "adafactor"
        return checkpoint_placements(self.mesh, p_specs, opt_state_specs(
            self.opt_state, p_specs, kind))

    def maybe_restore(self) -> int:
        if self.ckpt and self.ckpt.latest_step() is not None:
            if self.mesh is None:
                step, tree, _ = self.ckpt.restore()
            else:
                step, tree, _ = self.ckpt.restore(
                    placements=self._placements(), mesh=self.mesh)
            load_tree(self.params, tree["params"])
            self.opt_state = load_state_tree(self.opt_state,
                                             tree["opt_state"])
            self.step = step
        return self.step

    def save(self) -> None:
        if self.ckpt:
            keep = self.ckpt.writes
            self.ckpt.save(self.step, {
                "params": to_tree(self.params, keep),
                "opt_state": state_to_tree(self.opt_state, keep)})

    def run(self, batches: Iterator[Dict],
            hooks: Optional[Callable] = None) -> Dict[str, Any]:
        history = []
        t0 = time.time()
        last_good = self.step
        while self.step < self.tcfg.total_steps:
            # over a mesh the global batch stays on the host: each rank
            # moves its own rows of each microbatch
            batch = {k: torch.as_tensor(np.asarray(v), device=(
                self.device if self.mesh is None else None))
                for k, v in next(batches).items()}
            retries, rolled_back = 0, False
            while True:
                try:
                    loss, metrics = self._train_step(batch)
                    break
                except Exception:                      # transient failure
                    if self.mesh is not None:          # no rank retries
                        if self.ckpt:                  # publish the last
                            self.ckpt.wait(barrier=False)
                        raise
                    retries += 1
                    if retries <= self.tcfg.max_retries:
                        continue
                    if (self.tcfg.max_retries and not rolled_back
                            and self.ckpt
                            and self.ckpt.latest_step() is not None):
                        self.maybe_restore()           # roll back
                        last_good = self.step
                        retries, rolled_back = 0, True
                        continue
                    raise
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.total_steps:
                lv = float(loss)
                history.append({"step": self.step, "loss": lv,
                                "time": time.time() - t0})
                if hooks and self.rank == 0:
                    hooks(self.step, lv, metrics)
            if self.ckpt and self.step % self.tcfg.checkpoint_every == 0:
                self.save()
                last_good = self.step
        if self.ckpt:
            self.save()
            self.ckpt.wait()
        return {"history": history, "final_step": self.step,
                "last_good": last_good}

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
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (Optimizer, cosine_schedule,
                                         make_optimizer)
from repro_torch.train.params import (load_tree,
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


def state_to_tree(state: Dict) -> Dict:
    """An optimizer state -> the reference's tree (step as int32)."""
    return {k: (np.asarray(v, np.int32) if k == "step" else to_tree(v))
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
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.opt = opt or make_optimizer(
            tcfg.optimizer, cosine_schedule(tcfg.lr, tcfg.warmup,
                                            tcfg.total_steps))
        self.model = model
        self.params = param_groups(model)
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.loss_fn = loss_fn

    # ------------------------------------------------------------ step fn
    def _train_step(self, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = microbatch_value_and_grad(
            self.loss_fn, self.model, batch, self.tcfg.microbatches)
        finite = bool(torch.isfinite(loss))
        if finite or not self.tcfg.skip_nonfinite:
            self.opt_state = self.opt.update(self.params, grads,
                                             self.opt_state)
        return loss, metrics

    # ------------------------------------------------------------ running
    def maybe_restore(self) -> int:
        if self.ckpt and self.ckpt.latest_step() is not None:
            step, tree, _ = self.ckpt.restore()
            load_tree(self.params, tree["params"])
            self.opt_state = load_state_tree(self.opt_state,
                                             tree["opt_state"])
            self.step = step
        return self.step

    def save(self) -> None:
        if self.ckpt:
            self.ckpt.save(self.step, {
                "params": to_tree(self.params),
                "opt_state": state_to_tree(self.opt_state)})

    def run(self, batches: Iterator[Dict],
            hooks: Optional[Callable] = None) -> Dict[str, Any]:
        history = []
        t0 = time.time()
        last_good = self.step
        while self.step < self.tcfg.total_steps:
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in next(batches).items()}
            retries, rolled_back = 0, False
            while True:
                try:
                    loss, metrics = self._train_step(batch)
                    break
                except Exception:                      # transient failure
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
                if hooks:
                    hooks(self.step, lv, metrics)
            if self.ckpt and self.step % self.tcfg.checkpoint_every == 0:
                self.save()
                last_good = self.step
        if self.ckpt:
            self.save()
            self.ckpt.wait()
        return {"history": history, "final_step": self.step,
                "last_good": last_good}

"""Causal-LM training driver (``src/repro/launch/train.py``, without the
mesh: one card).

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 50
    python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke
    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 4 \\
        --batch 8 --seq 2048 --microbatches 2 --checkpoint-dir DIR

Random weights from seed 0, a synthetic token stream from seed 0
(``lm_batches``), and the fault-tolerant ``Trainer`` with the config's
optimizer under the cosine schedule. With ``--checkpoint-dir`` it resumes
from the latest checkpoint there (either package's) and fast-forwards the
stream to that step; it checkpoints every ``max(steps // 4, 10)`` steps
and at the end. A MoE trunk routes with ``moe_impl="dense"`` under
``--smoke`` and ``"capacity"`` otherwise, as the reference's driver
does. Runs on ``cuda`` unless ``--device`` names another.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TransformerConfig
from repro_torch.data.pipeline import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_transformer, lm_loss
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced test-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--max-retries", type=int, default=2,
                    help="retries of a failed step before the roll-back; "
                         "0: a failed step raises")
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a card)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if not isinstance(cfg, TransformerConfig):
        raise ValueError(f"{args.arch}: not a causal LM")
    moe_impl = "dense" if args.smoke else "capacity"
    dev = resolve_device(args.device)
    model = init_transformer(cfg, seed=0, device=dev)

    def loss_fn(m, batch):
        return lm_loss(m, batch["tokens"], batch["labels"], cfg,
                       moe_impl=moe_impl)

    tcfg = TrainConfig(total_steps=args.steps, lr=args.lr,
                       microbatches=args.microbatches,
                       checkpoint_dir=args.checkpoint_dir,
                       max_retries=args.max_retries,
                       optimizer=cfg.optimizer,
                       checkpoint_every=max(args.steps // 4, 10))
    # synthetic token stream (deterministic)
    rng = np.random.default_rng(0)
    stream = rng.integers(
        0, cfg.vocab_size, args.batch * args.seq * (args.steps + 8) + 1
    ).astype(np.int32)
    trainer = Trainer(loss_fn, model, tcfg, device=dev)
    if args.checkpoint_dir and trainer.maybe_restore():
        print(f"resumed from step {trainer.step}")
    batches = lm_batches(stream, args.batch, args.seq,
                         start_step=trainer.step)
    out = trainer.run(batches, hooks=lambda s, l, m: print(
        f"step {s}: loss {l:.4f}"))
    last = (f"; final loss {out['history'][-1]['loss']:.4f}"
            if out["history"] else "")
    print(f"finished at step {out['final_step']}{last}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

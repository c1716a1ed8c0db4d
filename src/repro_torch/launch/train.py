"""Causal-LM training driver (``src/repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 50
    python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --smoke
    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 4 \\
        --batch 8 --seq 2048 --microbatches 2 --checkpoint-dir DIR
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --device cpu --checkpoint-dir DIR

Random weights from seed 0, a synthetic token stream from seed 0
(``lm_batches``), and the fault-tolerant ``Trainer`` with the config's
optimizer under the cosine schedule. With ``--checkpoint-dir`` it resumes
from the latest checkpoint there (either package's, written by any
number of ranks) and fast-forwards the stream to that step; it
checkpoints every ``max(steps // 4, 10)`` steps and at the end. A MoE
trunk routes with ``moe_impl="dense"`` under ``--smoke`` and
``"capacity"`` otherwise, as the reference's driver does.

Started without ``WORLD_SIZE`` in its environment it trains on one
device, with no mesh: ``cuda`` unless ``--device`` names another.
Started by ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) it opens the default group (NCCL on
``cuda:LOCAL_RANK``, gloo under ``--device cpu``) and trains over a
mesh with the reference's rules (``lm_rules`` and ``lm_param_rules``
over the mesh's axes): every rank reads the same global batch and
lays out its own rows of it. The reference ties its mesh to
``--smoke``: the host mesh there, the production mesh (16, 16), or
(2, 16, 16) under ``--multi-pod``, otherwise. Here the production mesh
is taken when the launch has its 256 (512) ranks and ``--smoke`` is not
given, and the host mesh (1-D ``("data",)``: data parallelism with FSDP
over ``data``) otherwise: no launch in this repo has 256 ranks, and a
full config on a few cards trains over the host mesh.
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TransformerConfig
from repro_torch.data.pipeline import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_transformer, lm_loss
from repro_torch.train.trainer import TrainConfig, Trainer

GROUP_TIMEOUT_S = 300.0       # a collective waiting on a rank that is gone


def parse_args(argv=None) -> argparse.Namespace:
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
                         "0: a failed step raises (always so over a mesh)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh at 512 ranks")
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a card); under "
                         "torchrun cuda:LOCAL_RANK, or cpu (gloo)")
    return ap.parse_args(argv)


def launch_mesh(args, device):
    """The mesh of a ``torchrun`` launch (its default group open): the
    production mesh at its 256 (512) ranks unless ``--smoke``, the host
    mesh otherwise."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_host_mesh,
                                         make_production_mesh)
    shape, _ = PRODUCTION_SHAPES[bool(args.multi_pod)]
    if not args.smoke and dist.get_world_size() == math.prod(shape):
        return make_production_mesh(multi_pod=args.multi_pod, device=device)
    return make_host_mesh(device)


def run(args: argparse.Namespace, mesh=None, log=print):
    """One training run of the parsed ``args`` -> (the ``Trainer``, its
    ``run`` result): on ``args.device`` with no mesh, or over ``mesh``
    (the default group open; the model on this rank's device) with the
    reference's rules. ``log`` prints on rank 0."""
    from repro_torch.launch.mesh import batch_axes, fsdp_axes, model_axis
    from repro_torch.sharding.api import lm_rules
    from repro_torch.sharding.params import lm_param_rules
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
    if mesh is None:
        trainer = Trainer(loss_fn, model, tcfg, device=dev)
    else:
        trainer = Trainer(
            loss_fn, model, tcfg, device=dev, mesh=mesh,
            rules=lm_rules(batch_axes(mesh), model_axis(mesh),
                           attn_shard=cfg.attn_shard),
            param_rules=lm_param_rules(fsdp_axes(mesh), model_axis(mesh)))
    say = log if trainer.rank == 0 else (lambda *a: None)
    if mesh is not None:
        say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
            f"{mesh.size()} ranks ({mesh.device_type})")
    if args.checkpoint_dir and trainer.maybe_restore():
        say(f"resumed from step {trainer.step}")
    batches = lm_batches(stream, args.batch, args.seq,
                         start_step=trainer.step,
                         shard_count=None if mesh is None else 1)
    out = trainer.run(batches, hooks=lambda s, l, m: say(
        f"step {s}: loss {l:.4f}"))
    last = (f"; final loss {out['history'][-1]['loss']:.4f}"
            if out["history"] else "")
    say(f"finished at step {out['final_step']}{last}")
    return trainer, out


def main(argv=None) -> int:
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        run(args)
        return 0
    import torch
    from repro_torch.launch.mesh import process_group
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
    args.device = str(dev)
    with process_group(dev, world_size=int(os.environ["WORLD_SIZE"]),
                       rank=int(os.environ["RANK"]), init_method="env://",
                       timeout=GROUP_TIMEOUT_S):
        run(args, launch_mesh(args, dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

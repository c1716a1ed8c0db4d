"""One reduced-config loss and gradient for EVERY assigned architecture
(--arch all), or a single one, on the port (the port of
``examples/multi_arch_smoke.py``):

    PYTHONPATH=src python -m repro_torch.examples.multi_arch_smoke --arch dimenet
    PYTHONPATH=src python -m repro_torch.examples.multi_arch_smoke --arch all

Plain torch throughout: the MoE trunks route through the dense oracle,
and no kernel runs (the kernels' wrappers refuse autograd).
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.configs.base import (DimeNetConfig, RecsysConfig,
                                      TransformerConfig)
from repro_torch.device import resolve_device
from repro_torch.train.params import value_and_grad


def run_arch(arch: str, device: torch.device) -> float:
    """The loss of one step of ``arch``'s SMOKE config, its gradient
    taken; -> the loss."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    t0 = time.time()
    if isinstance(cfg, TransformerConfig):
        from repro_torch.models.transformer import init_transformer, lm_loss
        model = init_transformer(cfg, seed=0, device=device)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                               device=device)
        loss, _, _ = value_and_grad(
            lambda m: lm_loss(m, toks, toks, moe_impl="dense"), model)
    elif isinstance(cfg, DimeNetConfig):
        from repro_torch.models.gnn.dimenet import (build_triplets,
                                                    dimenet_loss,
                                                    init_dimenet)
        N, E = 12, 30
        src = rng.integers(0, N, E)
        dst = (src + 1 + rng.integers(0, N - 1, E)) % N
        ei = np.stack([src, dst]).astype(np.int32)
        t_in, t_out, t_mask = build_triplets(ei, N, cfg.triplet_cap)
        inputs = dict(pos=rng.normal(size=(N, 3)).astype(np.float32),
                      edge_index=ei, t_in=t_in, t_out=t_out, t_mask=t_mask,
                      node_mask=np.ones(N, bool), edge_mask=np.ones(E, bool),
                      z=rng.integers(1, 9, N).astype(np.int32),
                      graph_ids=np.zeros(N, np.int32))
        model = init_dimenet(cfg, seed=0, device=device)
        loss, _, _ = value_and_grad(lambda m: (dimenet_loss(
            m, inputs, np.zeros((1, 1), np.float32)), {}), model)
    elif isinstance(cfg, RecsysConfig):
        from repro_torch.models.recsys import init_recsys, recsys_loss
        model = init_recsys(cfg, seed=0, device=device)
        B = 16
        batch = {"sparse_ids": rng.integers(
            0, 50, (B, cfg.n_sparse, cfg.multi_hot)).astype(np.int32),
            "label": rng.integers(0, 2, B).astype(np.float32)}
        if cfg.n_dense:
            batch["dense"] = rng.normal(size=(B, cfg.n_dense)).astype(
                np.float32)
        loss, _, _ = value_and_grad(lambda m: recsys_loss(m, batch), model)
    else:
        raise TypeError(type(cfg))
    lv = float(loss)
    assert np.isfinite(lv), arch
    print(f"  {arch:24s} loss {lv:8.4f}  ({time.time()-t0:.1f}s)")
    return lv


def main(argv=None) -> dict:
    """Run the example; -> {arch: loss}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    print(f"running {len(archs)} architecture(s):")
    losses = {a: run_arch(a, dev) for a in archs}
    print("all architectures: forward+grad OK")
    return losses


if __name__ == "__main__":
    main()
    sys.exit(0)

"""End-to-end example on the port (the port of
``examples/train_colbert.py``): contrastively train a ColBERT encoder
with checkpoints, then index with token pooling and evaluate relative
performance.

Default (the SMOKE encoder):
    PYTHONPATH=src python -m repro_torch.examples.train_colbert --steps 80

The full ColBERTv2 trunk (110M parameters):
    PYTHONPATH=src python -m repro_torch.examples.train_colbert \
        --full --steps 300 --batch 8

Checkpoints go to ``--checkpoint-dir`` (default ``colbert_ckpt`` under
the temporary directory), in the JAX package's layout; ``--resume``
continues from the latest one.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.corpus import DATASET_SPECS, SyntheticRetrievalCorpus
from repro_torch.device import resolve_device
from repro_torch.eval import QualitySweep, synthetic_dataset
from repro_torch.models.colbert import colbert_loss, init_colbert
from repro_torch.train import TrainConfig, Trainer


def main(argv=None, model=None) -> dict:
    """Run the example; -> the printed figures: parameter count, the
    logged losses, the final step and the sweep's report. ``model``: a
    ColBERT to train in place of the seeded one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="full ColBERTv2 trunk (110M params)")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "colbert_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if model is None:
        cfg = get_config("colbertv2") if args.full \
            else get_smoke_config("colbertv2")
        model = init_colbert(cfg, seed=0, device=dev)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ColBERT encoder: {n_params/1e6:.1f}M params "
          f"(doc_maxlen={cfg.doc_maxlen})")

    trainer = Trainer(lambda m, b: colbert_loss(m, b["q"], b["d"]), model,
                      TrainConfig(total_steps=args.steps, log_every=20,
                                  checkpoint_every=50,
                                  checkpoint_dir=args.checkpoint_dir,
                                  lr=args.lr, warmup=10), device=dev)
    start = 0
    if args.resume:
        start = trainer.maybe_restore()
        if start:
            print(f"resumed from step {start}")

    corpus = SyntheticRetrievalCorpus(DATASET_SPECS["scidocs"],
                                      vocab_size=cfg.trunk.vocab_size)
    qs, ds = corpus.train_pairs(args.steps * args.batch, seed=1)
    qlen, dlen = cfg.query_maxlen - 2, min(cfg.doc_maxlen - 2, 64)

    def batches():
        for s in range(start, args.steps):
            q = np.zeros((args.batch, qlen), np.int32)
            d = np.zeros((args.batch, dlen), np.int32)
            for b in range(args.batch):
                qq = qs[s * args.batch + b][:qlen]
                dd = corpus.docs[ds[s * args.batch + b]][:dlen]
                q[b, :len(qq)], d[b, :len(dd)] = qq, dd
            yield {"q": q, "d": d}

    t0 = time.time()

    def log(step, loss, metrics):
        if step % 20 == 0:
            print(f"step {step:4d}: loss {loss:.4f} "
                  f"in-batch acc {float(metrics['acc']):.2f} "
                  f"({(time.time()-t0)/(step-start):.2f}s/step)")

    out = trainer.run(batches(), hooks=log)

    print("\nevaluating token pooling with the trained encoder...")
    dataset = synthetic_dataset("scifact", vocab_size=cfg.trunk.vocab_size,
                                doc_maxlen=cfg.doc_maxlen - 2,
                                query_maxlen=cfg.query_maxlen - 2)
    report = QualitySweep(model, dataset, methods=("ward",),
                          factors=(1, 2, 3, 4), backends=("plaid",),
                          metrics=("ndcg@10",),
                          device=dev).run(verbose=True)
    print(report.markdown_table("ndcg@10", backend="plaid", quant_bits=2))
    return {"n_params": n_params, "history": out["history"],
            "final_step": out["final_step"], "report": report.to_json()}


if __name__ == "__main__":
    main()
    sys.exit(0)

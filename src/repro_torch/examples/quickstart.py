"""Quickstart: token pooling end to end through the port's
``repro_torch.Retriever`` facade (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Build a synthetic retrieval corpus.
2. ``Retriever.build``: encode with the small ColBERT encoder, TOKEN-POOL
   the vectors (the paper's technique) at factor 2, index (PLAID 2-bit).
3. Search, and compare quality and footprint against the unpooled
   baseline: the paper's headline tradeoff, in one typed spec knob.
"""
import argparse
import sys

import repro_torch as rt
from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
from repro_torch.device import resolve_device
from repro_torch.retrieval.metrics import ndcg_at_k


def main(argv=None, model=None) -> dict:
    """Run the example; -> the printed figures. ``model``: a ColBERT to
    use in place of the seeded SMOKE encoder."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if model is None:
        model = rt.init_colbert(rt.get_smoke_config("colbertv2"), seed=0,
                                device=dev)
    cfg = model.cfg
    print(f"encoder: {cfg.trunk.n_layers}L d={cfg.trunk.d_model} "
          f"proj={cfg.proj_dim}")

    spec = DatasetSpec("quickstart", n_docs=150, n_queries=24, n_topics=8,
                       doc_len_mean=40, doc_len_std=8, seed=7)
    corpus = SyntheticRetrievalCorpus(spec, vocab_size=cfg.trunk.vocab_size)
    toks = corpus.doc_token_batch(cfg.doc_maxlen - 2)
    q = corpus.query_token_batch(cfg.query_maxlen - 2)
    print(f"corpus: {len(corpus.docs)} docs, {len(corpus.queries)} queries")

    def build(factor):
        # ONE typed spec drives encode -> pool -> index (-> save/serve)
        r = rt.Retriever.build(model, toks, rt.RetrieverSpec(
            pooling=rt.PoolingSpec(method="ward", factor=factor),
            index=rt.IndexSpec.from_config(cfg, backend="plaid")),
            device=dev)
        metric = ndcg_at_k(r.rankings(q, k=10), corpus.qrels, 10)
        return r, metric

    baseline, m_base = build(1)
    pooled, m_pool = build(2)

    rows = {}
    print(f"\n{'':12s} {'vectors':>8s} {'bytes':>9s} {'ndcg@10':>8s}")
    for name, r, m in (("unpooled", baseline, m_base),
                       ("ward f=2", pooled, m_pool)):
        print(f"{name:12s} {r.stats.n_vectors_stored:8d} "
              f"{r.stats.index_bytes:9d} {m:8.4f}")
        rows[name] = {"vectors": r.stats.n_vectors_stored,
                      "bytes": r.stats.index_bytes, "ndcg@10": m}
    rel = 100.0 * m_pool / m_base if m_base else 0.0
    print(f"\nhierarchical pooling @ factor 2: "
          f"{pooled.stats.vector_reduction:.0%} fewer vectors at "
          f"{rel:.1f}% relative NDCG@10 (the paper's headline result)")
    return {"rows": rows, "vector_reduction": pooled.stats.vector_reduction,
            "relative_ndcg": rel}


if __name__ == "__main__":
    main()
    sys.exit(0)

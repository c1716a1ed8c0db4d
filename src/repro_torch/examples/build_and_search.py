"""Index lifecycle example through the port's ``repro_torch.Retriever``
facade (the port of ``examples/build_and_search.py``): build a pooled
index, search it, persist and reload it, then exercise CRUD (add new
documents, delete stale ones) — the paper's §5 motivation: pooling makes
ColBERT viable on CRUD-friendly indexes like HNSW.

    PYTHONPATH=src python -m repro_torch.examples.build_and_search \
        --backend hnsw [--device cpu]
"""
import argparse
import sys
import tempfile

import repro_torch as rt
from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
from repro_torch.device import resolve_device


def main(argv=None, model=None) -> dict:
    """Run the example; -> the printed figures and each search's
    (scores, ids). ``model``: a ColBERT to use in place of the seeded
    SMOKE encoder."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="hnsw",
                    choices=rt.backend_names())
    ap.add_argument("--pool-factor", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if model is None:
        model = rt.init_colbert(rt.get_smoke_config("colbertv2"), seed=0,
                                device=dev)
    cfg = model.cfg
    spec = DatasetSpec("crud-demo", n_docs=120, n_queries=16, n_topics=6,
                       doc_len_mean=36, doc_len_std=6, seed=11)
    corpus = SyntheticRetrievalCorpus(spec, vocab_size=cfg.trunk.vocab_size)
    toks = corpus.doc_token_batch(cfg.doc_maxlen - 2)

    # 1. build with the first 100 docs — one typed spec, one call
    r = rt.Retriever.build(model, toks[:100], rt.RetrieverSpec(
        pooling=rt.PoolingSpec(method="ward", factor=args.pool_factor),
        index=rt.IndexSpec.from_config(cfg, backend=args.backend)),
        device=dev)
    stats = r.stats
    print(f"built {args.backend} index: {stats.n_docs} docs, "
          f"{stats.n_vectors_stored} vectors "
          f"({stats.vector_reduction:.0%} reduction), "
          f"{stats.index_bytes/2**10:.0f} KiB")

    q = corpus.query_token_batch(cfg.query_maxlen - 2)[:4]
    scores, ids = r.search(q, k=5)
    print("initial top-5 ids:", ids.tolist())

    # 2. persist + reload: the spec rides the artifact manifest
    with tempfile.TemporaryDirectory() as d:
        r.save(d)
        r2 = rt.Retriever.load(model, d, device=dev)
        assert r2.spec.index == r.spec.index
        print(f"reloaded from {d}: spec round-tripped, "
              f"{r2.index.n_docs} docs served from mmap")

    # 3. CRUD add: the remaining 20 docs arrive later
    new_ids = r.add(toks[100:])
    print(f"added docs {new_ids[0]}..{new_ids[-1]}")

    # 4. CRUD delete: remove the current best hit of query 0, re-search
    victim = int(ids[0][0])
    r.delete([victim])
    scores2, ids2 = r.search(q[:1], k=5)
    assert victim not in ids2[0].tolist()
    print(f"deleted doc {victim}; new top-5 for q0: {ids2[0].tolist()}")
    return {"n_docs": stats.n_docs, "vectors": stats.n_vectors_stored,
            "vector_reduction": stats.vector_reduction,
            "index_bytes": stats.index_bytes, "initial": (scores, ids),
            "added": [int(new_ids[0]), int(new_ids[-1])], "victim": victim,
            "after_delete": (scores2, ids2)}


if __name__ == "__main__":
    main()
    sys.exit(0)

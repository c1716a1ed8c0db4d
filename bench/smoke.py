"""Each cell at a size a CPU test run holds: the cell's kind and shape of
traffic, a two-layer encoder of width 64 (the program's SMOKE trunk),
a few dozen documents. The CPU tests drive ``run.run_cell`` with these
specs; nothing here is a measurement."""
from __future__ import annotations

import copy
from pathlib import Path

from bench.run import ROOT, cell_spec, load_json

SMOKE_MODEL = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                   vocab_size=1024, max_seq_len=64, norm_eps=1e-12,
                   proj_dim=32, doc_maxlen=48, query_maxlen=8,
                   compute_dtype="bfloat16", param_dtype="float32")

SMOKE_TRAFFIC = {
    "build": dict(docs_per_build=48, pool_slices=2, encode_batch=16,
                  check_queries=4, check_docs=24, check_encode=8),
    "closed_batch": dict(n_docs=96, encode_batch=32, n_queries=64, batch=16,
                         query_encode_batch=16, check_sample=24,
                         check_encode=8),
}


def smoke_spec(cell: str) -> dict:
    """The spec of a cell (``cell_spec``), shrunk: the model's widths,
    the corpus, the index's centroids and ``ndocs``."""
    spec = copy.deepcopy(
        cell_spec(load_json(Path(ROOT) / "BENCHMARK.json"), cell))
    spec["cfg"]["model"].update(SMOKE_MODEL)
    spec["cfg"]["index"].update(n_centroids=16, ndocs=32,
                                codec_sample=1 << 16)
    t = spec["traffic"]
    t.update(SMOKE_TRAFFIC[t["kind"]])
    t["corpus"] = dict(t["corpus"], doc_len_mean=30, doc_len_std=8,
                       n_topics=4, private_vocab=60, common_vocab=120,
                       query_len=[3, 6])
    return spec

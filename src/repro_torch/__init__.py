"""Token pooling for multi-vector retrieval — PyTorch / CUDA (Hopper) port.

The JAX package (``src/repro``), rewritten for one NVIDIA H100, slice
by slice: ColBERT encode -> token pooling (sequential, k-means or Ward)
-> PLAID 2-bit or flat index, or the pooled two-level cascade,
artifacts in the JAX package's format both ways, and query encode ->
device or host probe/prune -> packed, f32 or dense rerank -> top-k. The Pallas kernels on those paths are hand-written CUDA kernels
here (``csrc/``), built with ``nvcc`` at first use.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``::

    import repro_torch as rt

    model = rt.init_colbert(rt.CONFIG, seed=0)
    index, stats = rt.Indexer(model, pooling_spec=rt.PoolingSpec("ward", 2)
                              ).build(doc_tokens, out_dir="idx")
    scores, ids = rt.Searcher.from_dir(model, "idx").search(query_tokens,
                                                            k=10)

Attributes resolve lazily so ``import repro_torch`` stays cheap.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CONFIG": "repro_torch.configs.colbertv2",
    "JA_CONFIG": "repro_torch.configs.colbertv2",
    "SMOKE": "repro_torch.configs.colbertv2",
    "IndexSpec": "repro_torch.core.spec",
    "PoolingSpec": "repro_torch.core.spec",
    "MultiVectorIndex": "repro_torch.core.index",
    "Indexer": "repro_torch.retrieval.indexer",
    "IndexStats": "repro_torch.retrieval.indexer",
    "Searcher": "repro_torch.retrieval.searcher",
    "CascadeIndex": "repro_torch.retrieval.cascade",
    "build_cascade": "repro_torch.retrieval.cascade",
    "ColBERT": "repro_torch.models.colbert",
    "init_colbert": "repro_torch.models.colbert",
    "params_from_jax": "repro_torch.models.colbert",
    "resolve_device": "repro_torch.device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

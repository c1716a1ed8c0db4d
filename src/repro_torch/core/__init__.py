"""Pooling, PLAID index and search for the port: the counterparts of
``repro.core.__all__``."""
from repro_torch.core.pooling import (METHODS, compact_pooled,
                                      pool_doc_embeddings, vector_counts)
from repro_torch.core.maxsim import (maxsim_scores, maxsim_scores_blocked,
                                     topk_docs)
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.sharded import ShardedIndex
from repro_torch.core.persist import (IndexFormatError, artifact_bytes,
                                      load_artifact, load_index,
                                      load_sharded, save_index, save_sharded)

__all__ = [
    "METHODS", "compact_pooled", "pool_doc_embeddings", "vector_counts",
    "maxsim_scores", "maxsim_scores_blocked", "topk_docs",
    "MultiVectorIndex", "ShardedIndex",
    "IndexFormatError", "artifact_bytes", "load_artifact", "load_index",
    "load_sharded", "save_index", "save_sharded",
]

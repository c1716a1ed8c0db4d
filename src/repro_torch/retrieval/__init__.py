"""Indexer and Searcher: the port's user-facing pipeline, with the
ranking metrics and the pooling-evaluation shim (the counterparts of
``repro.retrieval.__all__``)."""
from repro_torch.retrieval.indexer import Indexer
from repro_torch.retrieval.searcher import Searcher
from repro_torch.retrieval.metrics import ndcg_at_k, recall_at_k, success_at_k
from repro_torch.retrieval.evaluate import (evaluate_pooling,
                                            relative_performance)

__all__ = ["Indexer", "Searcher", "ndcg_at_k", "recall_at_k",
           "success_at_k", "evaluate_pooling", "relative_performance"]

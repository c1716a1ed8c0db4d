"""The recsys models (``src/repro/models/recsys``): Wide & Deep, DeepFM,
FM and DLRM over stacked embedding tables."""
from repro_torch.models.recsys.embedding import embedding_bag, init_tables
from repro_torch.models.recsys.models import (Recsys, init_recsys,
                                              recsys_forward, recsys_loss,
                                              score_candidates)

__all__ = ["embedding_bag", "init_tables", "Recsys", "init_recsys",
           "recsys_forward", "recsys_loss", "score_candidates"]

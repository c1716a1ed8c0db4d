"""Offline data: hash tokenizer, synthetic retrieval corpora and the
training data pipeline (the counterparts of ``repro.data.__all__``)."""
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.corpus import SyntheticRetrievalCorpus, DATASET_SPECS
from repro_torch.data.pipeline import DataPipeline, lm_batches

__all__ = ["HashTokenizer", "SyntheticRetrievalCorpus", "DATASET_SPECS",
           "DataPipeline", "lm_batches"]

"""Offline data: hash tokenizer, synthetic retrieval corpora and the
training data pipeline."""

"""Offline data: hash tokenizer and synthetic retrieval corpora."""

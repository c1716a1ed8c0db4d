"""Indexer and Searcher: the port's user-facing pipeline."""

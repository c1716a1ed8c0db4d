"""Idle ms a batch inside ``search.index`` and its children (the card
waits on the host in index search)."""
from bench.spans import INDEX_SEARCH, per_span


def read(ctx):
    return per_span(ctx, INDEX_SEARCH, "idle_s", "search.index", 1e3)

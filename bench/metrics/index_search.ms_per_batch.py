"""Host ms of ``Searcher.search_encoded`` a batch (ids and scores on the
host), from the benchmark's spans in the traced run."""
from bench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, "index_search")

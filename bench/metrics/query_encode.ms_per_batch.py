"""Host ms of ``Searcher.encode_queries`` a batch, synchronised, from the
benchmark's spans in the traced run."""
from bench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, "query_encode")

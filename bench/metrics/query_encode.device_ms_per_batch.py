"""Device ms a batch of the activities launched inside ``search.encode``
(``Searcher.encode_queries``), from the program's spans in the traced run."""
from bench.spans import per_span


def read(ctx):
    return per_span(ctx, ("search.encode",), "device_s", "search.encode", 1e3)

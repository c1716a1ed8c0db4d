"""Device ms a batch of the exact rerank: the activities launched inside
``search.packed_gather`` and ``search.maxsim_packed`` (or
``search.maxsim_rerank``), over the count of ``search.index``."""
from bench.spans import RERANK, per_span


def read(ctx):
    return per_span(ctx, RERANK, "device_s", "search.index", 1e3)

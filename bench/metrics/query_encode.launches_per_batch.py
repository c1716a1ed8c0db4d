"""Kernels launched inside ``search.encode``, a batch."""
from bench.spans import per_span


def read(ctx):
    return per_span(ctx, ("search.encode",), "launches", "search.encode")

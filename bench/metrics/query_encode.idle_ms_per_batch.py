"""Idle ms a batch inside ``search.encode``: the traced window's time
with nothing on the card that falls inside the span."""
from bench.spans import per_span


def read(ctx):
    return per_span(ctx, ("search.encode",), "idle_s", "search.encode", 1e3)

"""Device (encode, pool) or synchronised host (index, save) seconds of
the ``encode`` stage (``IndexStats.stage_seconds``) over the window's
builds, in ms per 1,000 documents."""
from bench.metrics import stage_ms_per_kdoc


def read(ctx):
    return stage_ms_per_kdoc(ctx, "encode")

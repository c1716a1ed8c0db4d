"""Device ms a batch of candidate generation: the activities launched
inside ``search.centroid_scores`` through ``search.prune``, over the
count of ``search.index``."""
from bench.spans import CANDIDATES, per_span


def read(ctx):
    return per_span(ctx, CANDIDATES, "device_s", "search.index", 1e3)

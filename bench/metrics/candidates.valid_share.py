"""Share of the slots ``plaid_probe`` scores that hold a valid candidate:
100 x ``search.probe_candidates`` / ``search.probe_slots``."""
from bench.spans import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "search.probe_candidates", "search.probe_slots",
                         100.0)

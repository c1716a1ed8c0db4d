"""Blocking device-to-host reads a batch of index search: the program's
counters ``search.host_reads`` over ``search.batches``."""
from bench.spans import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "search.host_reads", "search.batches")

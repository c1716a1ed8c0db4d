"""``plaid_probe``'s bound time over its device time (``bench/roofline.py``)."""
from bench.roofline import share


def read(ctx):
    return share(ctx, "plaid_probe")

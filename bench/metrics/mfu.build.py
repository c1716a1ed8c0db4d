"""The encoder's FLOPs at each document's own length over the window's
builds, over the window times the bf16 peak (989 TFLOP/s)."""
from bench.metrics import mfu_percent


def read(ctx):
    return mfu_percent(ctx)

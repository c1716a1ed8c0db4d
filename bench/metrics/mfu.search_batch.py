"""The query encoder's FLOPs at query_maxlen over the window's queries,
over the window times the bf16 peak (989 TFLOP/s)."""
from bench.metrics import mfu_percent


def read(ctx):
    return mfu_percent(ctx)

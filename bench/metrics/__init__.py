"""Per-layer readers: ``<metric name>.py`` holds ``read(ctx)``, which
returns the metric's value from the traced run's context, or None where
it finds nothing to read (the harness then leaves the metric out).

The context (``bench/run.py``): ``window_s`` (the measured window,
host clock), ``busy_s`` and ``trace_window_s`` (the device trace),
``kernel_s`` (device seconds by kernel), ``counts`` (the roofline counts
of each kernel entry point), and what the cell's job adds: ``stage_s``,
``docs`` and ``stored`` of the builds, ``flops_bf16`` of the encoder,
``spans`` and ``queries`` of the closed-loop client.
"""


def idle_percent(ctx):
    if not ctx.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])


def stage_ms_per_kdoc(ctx, stage):
    s = ctx.get("stage_s", {}).get(stage)
    if s is None or not ctx.get("docs"):
        return None
    return 1e6 * s / ctx["docs"]


def mfu_percent(ctx):
    from bench.roofline import PEAK_BF16
    if not ctx.get("flops_bf16") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops_bf16"] / (ctx["window_s"] * PEAK_BF16)


def span_ms(ctx, name):
    xs = ctx.get("spans", {}).get(name)
    return 1e3 * sum(xs) / len(xs) if xs else None

"""Idle ms per 1,000 documents inside ``build.index`` and its children
(k-means, codec, codes, IVF, device views): the card waits on the
host in the PLAID build."""
from bench.spans import BUILD_INDEX, span_total


def read(ctx):
    idle = span_total(ctx, BUILD_INDEX, "idle_s")
    if idle is None or not ctx.get("docs"):
        return None
    return 1e6 * idle / ctx["docs"]

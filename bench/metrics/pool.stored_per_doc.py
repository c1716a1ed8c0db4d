"""Vectors stored a document (``IndexStats.n_vectors_stored / n_docs``)
over the window's builds."""


def read(ctx):
    if not ctx.get("docs"):
        return None
    return ctx["stored"] / ctx["docs"]

"""Search driver: the host's own time in a search (query parse, the
per-record hit loop of `find_batched`, GFF3 rows), ms per search: the
operation's wall minus its `search.tables`, `search.batch` and
`search.locate` spans."""

SPANS = ("search.tables", "search.batch", "search.locate")


def read(ctx):
    if not ctx.ops or "search.tables" not in ctx.spans:
        return None
    inner = sum(ctx.spans[n].seconds for n in SPANS if n in ctx.spans)
    return (ctx.op_seconds - inner) * 1e3 / ctx.ops

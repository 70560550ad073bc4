"""Query state and tables: `search.locate`'s time over the rows it located
(the `search.located_rows` counter), ns a row."""


def read(ctx):
    locate, rows = ctx.spans.get("search.locate"), ctx.spans.get(
        "search.located_rows")
    if locate is None or not getattr(rows, "count", 0):
        return None
    return locate.seconds * 1e9 / rows.count

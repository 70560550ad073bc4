"""Block encode, suffix sort and SA state: the `sa.rounds` counter (one for
each flag the host reads back to end a doubling round of the sort, each a
host sync), rounds per compress."""


def read(ctx):
    st = ctx.spans.get("sa.rounds")
    if st is None or not ctx.ops or not getattr(st, "count", 0):
        return None
    return st.count / ctx.ops

"""Driver: the self time of the root phase `search`, the whole verb less
its direct child phases on the calling thread: the host time that no
span names, ms per search."""


def read(ctx):
    st = ctx.spans.get("search")
    if st is None or not ctx.ops:
        return None
    return st.self_seconds * 1e3 / ctx.ops

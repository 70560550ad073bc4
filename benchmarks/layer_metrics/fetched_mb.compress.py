"""Block encode, serialization: the `mesh.fetched_bytes` counter (the
sampled-SA marks, the sampled values and the wavelet node bits fetched
from the card), MB per compress."""


def read(ctx):
    st = ctx.spans.get("mesh.fetched_bytes")
    if st is None or not ctx.ops or not getattr(st, "count", 0):
        return None
    return st.count / 1e6 / ctx.ops

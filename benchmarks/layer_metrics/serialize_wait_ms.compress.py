"""Block encode, serialization: `mesh.serialize_wait` (the calling thread
waiting for the serialization workers), ms per compress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "mesh.serialize_wait")

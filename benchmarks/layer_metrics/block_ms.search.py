"""Search driver: `search.block` (one block's whole search: its read, its
tables, K1, the locate, the record ends and the split) over the counter
`search.blocks`, ms a block."""


def read(ctx):
    block, blocks = ctx.spans.get("search.block"), ctx.spans.get(
        "search.blocks")
    if block is None or not getattr(blocks, "count", 0):
        return None
    return block.seconds * 1e3 / blocks.count

"""FASTA reader: the share of the query records that the bulk path parsed
(counter `search.query_records_bulk` over `search.query_records`, both
counted once a query file), in the measured window."""


def read(ctx):
    records = ctx.spans.get("search.query_records")
    if records is None or not getattr(records, "count", 0):
        return None
    bulk = ctx.spans.get("search.query_records_bulk")
    return getattr(bulk, "count", 0) / records.count

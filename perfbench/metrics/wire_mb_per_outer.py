"""The payload a rank of a world hands to its transport's backend an outer
iteration, in MB: the program's ``wire_bytes`` counter (the reductions'
lanes, the faces ``route`` sends; not the result's gather) over its
``shard.outer`` spans, over the traced run's window (rank 0's)."""


def read(ctx):
    wire = (getattr(ctx, "counts", None) or {}).get("wire_bytes")
    outer = (getattr(ctx, "span_totals", None) or {}).get("shard.outer")
    if wire is None or not outer or not outer["count"]:
        return None
    return wire / outer["count"] / 1e6

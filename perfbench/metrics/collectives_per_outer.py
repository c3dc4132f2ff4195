"""The backend operations a rank of a world launches an outer iteration:
the program's ``collectives`` counter (one an ``all_reduce``, one each
``isend`` and ``irecv`` of a face exchange) over its ``shard.outer``
spans, over the traced run's window (rank 0's)."""


def read(ctx):
    ops = (getattr(ctx, "counts", None) or {}).get("collectives")
    outer = (getattr(ctx, "span_totals", None) or {}).get("shard.outer")
    if ops is None or not outer or not outer["count"]:
        return None
    return ops / outer["count"]

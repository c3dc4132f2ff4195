"""The host's wait at the monitor's read of ``converged``: the program's
``shard.sync`` spans in ms an outer iteration (``shard.outer``), over the
traced run's window (rank 0's spans).  It is the card's time the
host's dispatch did not cover."""


def read(ctx):
    totals = getattr(ctx, "span_totals", None) or {}
    outer, sync = totals.get("shard.outer"), totals.get("shard.sync")
    if not outer or not outer["count"] or not sync:
        return None
    return 1e3 * sync["seconds"] / outer["count"]

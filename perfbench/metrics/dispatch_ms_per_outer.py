"""The host's dispatch an outer iteration: the program's ``shard.outer``
spans less their ``shard.sync`` (the wait at the read of ``converged``),
in ms an outer iteration, over the traced run's window (rank
0's spans)."""


def read(ctx):
    totals = getattr(ctx, "span_totals", None) or {}
    outer = totals.get("shard.outer")
    if not outer or not outer["count"]:
        return None
    sync = totals.get("shard.sync", {}).get("seconds", 0.0)
    return 1e3 * (outer["seconds"] - sync) / outer["count"]

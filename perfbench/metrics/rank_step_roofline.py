"""A rank's least time an outer iteration over the traced run's
``outer_ms``, in a world of one shard a card: the whole grid's least time
(``_roofline.least_seconds``, at one card's peaks) over the ``shards``
that share it."""
from perfbench.metrics import _roofline


def read(ctx):
    least = _roofline.least_seconds(ctx)
    if least is None or not ctx.outer_s:
        return None
    return 100.0 * least / int(ctx.config["shards"]) / ctx.outer_s

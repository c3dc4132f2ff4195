"""A rank's least time an outer iteration (``rank_step_roofline``'s) over
the ranks' mean device time of all kernels an outer iteration, in a world
of one shard a card.  All kernels: NCCL's all-reduce, send/receive and
all-gather count beside #3 and #5, as the profiler records them."""
from perfbench.metrics import _roofline


def read(ctx):
    least = _roofline.least_seconds(ctx)
    if least is None or not ctx.outers or not ctx.kernel_s:
        return None
    return 100.0 * least / int(ctx.config["shards"]) / (ctx.kernel_s / ctx.outers)

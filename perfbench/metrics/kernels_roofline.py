"""The least time an outer iteration needs (``_roofline.least_seconds``)
over the summed device time of all kernels an outer iteration, whatever
kernels they are."""
from perfbench.metrics import _roofline


def read(ctx):
    least = _roofline.least_seconds(ctx)
    if least is None or not ctx.outers or not ctx.kernel_s:
        return None
    return 100.0 * least / (ctx.kernel_s / ctx.outers)

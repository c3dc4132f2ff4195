"""The least time an outer iteration needs (``_roofline.least_seconds``)
over the traced run's ``outer_ms``: the window's wall over its outer
iterations, unslowed by the profiler.  It bounds a claim on the whole
iteration, whichever kernels run in it."""
from perfbench.metrics import _roofline


def read(ctx):
    least = _roofline.least_seconds(ctx)
    if least is None or not ctx.outer_s:
        return None
    return 100.0 * least / ctx.outer_s

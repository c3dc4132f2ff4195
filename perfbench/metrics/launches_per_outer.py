"""Device kernels the profiler recorded, over the outer iterations of the
profiled sub-window: the shard loop's dispatch, one launch at a time."""


def read(ctx):
    if not ctx.outers:
        return None
    return ctx.kernel_count / ctx.outers

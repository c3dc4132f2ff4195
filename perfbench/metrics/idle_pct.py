"""The share of the profiled sub-window in which no kernel, copy or fill
runs on the device: one less the union of their intervals over its wall."""


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

"""Synchronising CUDA calls counted under ``torch.cuda.set_sync_debug_mode``
over the outer iterations of its sub-window; the loop is built to make
one, its read of the monitor's ``converged``."""


def read(ctx):
    if not ctx.sync_outers:
        return None
    return ctx.syncs / ctx.sync_outers

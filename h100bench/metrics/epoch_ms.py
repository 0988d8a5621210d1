"""epoch_ms: Whole window (host clock, ending in a device sync) over the epochs it
completed: train steps, every fifth epoch's evaluation and the host work
between them."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.epochs if ctx.epochs else None

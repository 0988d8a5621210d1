"""device.idle_pct: 100 minus the union of device activity over the profiled periods, in %
of their length."""


def read(ctx):
    return None if ctx.trace is None or ctx.trace.window_s <= 0 else \
        100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

"""ops.route_misses: Kernel-route misses a window epoch: the difference of
`fastpath_misses()` over the window."""


def read(ctx):
    return ctx.per_epoch(ctx.counters1["route_misses"] - ctx.counters0["route_misses"])

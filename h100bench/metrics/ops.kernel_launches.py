"""ops.kernel_launches: Launches of the port's kernels a window epoch: the difference of the
wrappers' `.launches` counters over the window."""


def read(ctx):
    return ctx.per_epoch(sum(ctx.counters1["launches"].values())
                         - sum(ctx.counters0["launches"].values()))

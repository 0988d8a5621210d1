"""gen.kernel_launches: Launches of GENConv's fused aggregation kernels a window epoch: the
difference of K2's and K4's `.launches` counters over the window."""


def read(ctx):
    d = {k: ctx.counters1["launches"].get(k, 0) - ctx.counters0["launches"].get(k, 0)
         for k in ("K2", "K4")}
    return ctx.per_epoch(d["K2"] + d["K4"])

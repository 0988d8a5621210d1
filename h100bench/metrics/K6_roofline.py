"""K6_roofline: K6's share of its roofline over the profiled periods: the least time
(bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, from `costs/K6.py` and
the configuration's kernel calls) over its device time by its `dgc::` name."""


def read(ctx):
    return ctx.roofline("K6")

"""K2_roofline: K2's share of its roofline over the profiled periods: the least time
(bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s, an accurate expf
as 16 of them, from `costs/K2.py` and the configuration's kernel calls)
over its device time by its `dgc::` name."""


def read(ctx):
    return ctx.roofline("K2")

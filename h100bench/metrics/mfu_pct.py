"""mfu_pct: Model FLOPs of the profiled periods (the configuration's count: the
matmuls and the per-edge aggregation, evaluation forwards included,
recomputation not) over their length at the float32 peak, in %."""


def read(ctx):
    return ctx.mfu()

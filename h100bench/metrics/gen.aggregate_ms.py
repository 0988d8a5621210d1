"""gen.aggregate_ms: Device ms of the port's `gen.aggregate` spans (GENConv's
aggregation (the fused route's K2 forward in this cell: training forwards and
evaluations)) over the profiled periods, per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("gen.aggregate")
    return None if s is None else s["device_ms"] / ctx.trace_steps

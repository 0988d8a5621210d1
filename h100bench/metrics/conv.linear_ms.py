"""conv.linear_ms: Device ms of the port's `conv.linear` spans (each conv's `fc` and `res_fc`
products: training forwards, reversible recomputes and evaluations) over the
profiled periods, per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("conv.linear")
    return None if s is None else s["device_ms"] / ctx.trace_steps

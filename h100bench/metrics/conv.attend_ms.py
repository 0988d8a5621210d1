"""conv.attend_ms: Device ms of the port's `conv.attend` spans (each conv from the
sender-side scaling through the edge-drop mask, the scores and the route's
aggregation, K5 on the CSC route, to the receiver-side scaling) over the
profiled periods, per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("conv.attend")
    return None if s is None else s["device_ms"] / ctx.trace_steps

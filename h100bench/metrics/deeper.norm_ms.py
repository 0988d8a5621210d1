"""deeper.norm_ms: Device ms of the port's `deeper.norm` spans (each res+ prologue's
batch norm, ReLU and dropout, and the final norm, ReLU and dropout) over the
profiled periods, per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("deeper.norm")
    return None if s is None else s["device_ms"] / ctx.trace_steps

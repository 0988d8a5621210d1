"""rev.vjp_ms: Device ms of the port's `rev.vjp` spans (the reversible backward's
`torch.autograd.grad` of each group function) over the profiled periods, per
epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("rev.vjp")
    return None if s is None else s["device_ms"] / ctx.trace_steps

"""block.norm_ms: Device ms of the port's `block.norm` spans (each RevGAT block's and the
head's batch-statistics norm, ReLU and dropout) over the profiled periods,
per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("block.norm")
    return None if s is None else s["device_ms"] / ctx.trace_steps

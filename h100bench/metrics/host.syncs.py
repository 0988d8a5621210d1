"""host.syncs: The port's device-to-host reads on the training and evaluation path (its
`host.sync` spans, one a read) over the profiled periods, per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("host.sync")
    return None if s is None else s["count"] / ctx.trace_steps

"""host.sync_wait_ms: Host ms blocked in the port's device-to-host reads (its `host.sync` spans)
over the profiled periods, per epoch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    from deep_gcns_torch_tpu_torch.utils import profiling

    s = getattr(profiling, "summary", dict)().get("host.sync")
    return None if s is None else s["host_ms"] / ctx.trace_steps

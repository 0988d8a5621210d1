"""model.fwd_ms: Mean training forward: CUDA events at the model's forward pre- and
post-hooks."""

from h100bench import harness


def read(ctx):
    return harness.mean(ctx.fwd_ms)

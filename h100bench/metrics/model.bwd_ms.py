"""model.bwd_ms: Mean backward: CUDA events from the model's forward post-hook to the
optimizer's step pre-hook (the loss, the backward and any recomputation)."""

from h100bench import harness


def read(ctx):
    return harness.mean(ctx.bwd_ms)

"""optim.step_ms: Mean optimizer step: CUDA events at the optimizer's step pre- and
post-hooks."""

from h100bench import harness


def read(ctx):
    return harness.mean(ctx.step_ms)

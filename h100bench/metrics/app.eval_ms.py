"""app.eval_ms: Mean of CUDA events around each `predict` of the window."""

from h100bench import harness


def read(ctx):
    return harness.mean(ctx.eval_ms)

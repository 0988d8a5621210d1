"""setup_s: Process start to the first timed epoch: imports, inputs, the host build,
the model, the weights and the warm-up period (the first run in a checkout
also builds the kernels)."""


def read(ctx):
    return ctx.setup_s

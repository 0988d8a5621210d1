"""host.build_s: Host clock from the generated arrays to the graph on the device (the
port's builders)."""


def read(ctx):
    return ctx.host_build_s

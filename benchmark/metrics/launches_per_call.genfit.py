"""Device launches (kernels, copies, sets) a generate+fit call in the traced window."""

from benchmark.readers import per_unit


def read(ctx):
    return per_unit(ctx, ctx.trace.launches) if ctx.trace is not None and ctx.trace.device else None

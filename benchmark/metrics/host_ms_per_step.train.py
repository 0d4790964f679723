"""Host milliseconds of one training step: its forward, backward and
optimizer spans, summed."""

from benchmark.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx.trace)

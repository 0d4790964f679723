"""Host milliseconds of one pass of the fit (a ``psi.fit.pass.*`` span)."""

from benchmark.spans import host_ms_per_pass


def read(ctx):
    return host_ms_per_pass(ctx.trace)

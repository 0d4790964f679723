"""Host milliseconds of one pass of the fit (a ``psi.fit.pass.*`` span); of
a fit that replays its CUDA graph, the replay's (``psi.fit.replay``) over
the traffic's ``num_iter`` passes that it replays."""

from benchmark.spans import host_ms_per_pass


def read(ctx):
    return host_ms_per_pass(ctx.trace, ctx.run.traffic["num_iter"] if ctx.run is not None else None)

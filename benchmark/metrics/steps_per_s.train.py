"""Training steps over the wall time of the window's untraced part: the
steps a user sees per second, paced by the host that launches them."""

from benchmark.readers import rest_rate


def read(ctx):
    return rest_rate(ctx)

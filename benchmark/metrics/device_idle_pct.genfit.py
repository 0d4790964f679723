"""Share of the traced window in which no operation ran on the device."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)

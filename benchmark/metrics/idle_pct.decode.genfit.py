"""Share of the traced window in which the device idled while the host was
in the fit's body decode (``psi.fit.decode``)."""

from benchmark.spans import GENFIT, idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, GENFIT, "psi.fit.decode")

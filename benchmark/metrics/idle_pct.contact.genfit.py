"""Share of the traced window in which the device idled while the host was
in the fit's contact term (``psi.fit.contact``: the pruning and the NN search)."""

from benchmark.spans import GENFIT, idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, GENFIT, "psi.fit.contact")

"""Share of the traced window in which the device idled while the host was
in the sampler (``psi.sample``: the CVAE's draw and the recovery of the global translation)."""

from benchmark.spans import GENFIT, idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, GENFIT, "psi.sample")

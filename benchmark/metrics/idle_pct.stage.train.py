"""Share of the traced window in which the device idled while the host was
in the staging of a batch (``psi.train.stage``: the stack, the pin and the copy)."""

from benchmark.spans import TRAIN, idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, TRAIN, "psi.train.stage")

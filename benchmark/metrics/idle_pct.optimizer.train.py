"""Share of the traced window in which the device idled while the host was
in the training step's optimizer (``psi.train.optimizer``: the clip and Adam)."""

from benchmark.spans import TRAIN, idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, TRAIN, "psi.train.optimizer")

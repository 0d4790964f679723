"""Share of the traced window in which the device idled while the host was
in the training step's forward (``psi.train.forward``: ``zero_grad`` and ``cvae_loss``)."""

from benchmark.spans import TRAIN, idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, TRAIN, "psi.train.forward")

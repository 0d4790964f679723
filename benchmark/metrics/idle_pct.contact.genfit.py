"""Share of the traced window in which the device idled while the host was
in the fit's contact term (``psi.fit.contact``: the pruning and the NN search). A fit that
replays its CUDA graph never enters the phase on the host: 0."""

from benchmark.spans import fit_phase_idle_pct


def read(ctx):
    return fit_phase_idle_pct(ctx, "psi.fit.contact")

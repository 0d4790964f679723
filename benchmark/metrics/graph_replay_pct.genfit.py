"""Share of the traced generate+fit calls whose fit replayed a CUDA graph:
100 x (the ``bench.genfit_call`` spans that hold a ``psi.fit.replay`` span) /
(the ``bench.genfit_call`` spans), from the trace alone. A program that runs
its fit eagerly opens no such span and reads 0. Nothing without device events
or calls."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    calls = [(s, e) for s, e, n in t.host if n == "bench.genfit_call"]
    if not calls:
        return None
    replays = [(s, e) for s, e, n in t.host if n == "psi.fit.replay"]
    held = sum(any(s <= a and b <= e for a, b in replays) for s, e in calls)
    return 100.0 * held / len(calls)

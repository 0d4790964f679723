"""Share of the window spent waiting inside the native loader's
``next_batch``, timed by the benchmark around each call."""


def read(ctx):
    c = ctx.counters
    return 100.0 * c["loader_s"] / c["window_s"] if c.get("window_s") else None

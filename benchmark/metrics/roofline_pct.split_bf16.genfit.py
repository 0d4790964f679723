"""The 'high' tier's products (K4) and their gradients (K5:
``ops/precision.py``) against their bound, each counted once as a float32
product: every iteration of a call runs both products and both gradients."""

from benchmark.costs import psi
from benchmark.readers import body_sizes, roofline_pct

KERNELS = ("split_",)


def read(ctx):
    V, J, L, P = body_sizes(ctx.run.config)
    tr = ctx.run.traffic
    return roofline_pct(ctx, tr["num_iter"] * psi.high_pass_s(tr["population"], P, V, J), KERNELS)

"""The 'high' tier's products (K4) and their gradients (K5) in a training
step's body decode, against their bound, each counted once as a float32
product."""

from benchmark.costs import psi
from benchmark.readers import body_sizes, roofline_pct

KERNELS = ("split_",)


def read(ctx):
    V, J, L, P = body_sizes(ctx.run.config)
    return roofline_pct(ctx, psi.high_pass_s(ctx.run.traffic["batch_size"], P, V, J), KERNELS)

"""The fused vertex path (K1 forward, K2 backward: ``ops/fused_skinning.py``)
against its bound: every iteration of a call decodes the whole population
through both."""

from benchmark.costs import psi
from benchmark.readers import body_sizes, roofline_pct

KERNELS = ("skin_", "splitk_gemm_kernel", "reduce_tiles_kernel")


def read(ctx):
    V, J, L, P = body_sizes(ctx.run.config)
    tr = ctx.run.traffic
    b = psi.skinning(tr["population"], 1 + L + P, J, V)
    return roofline_pct(ctx, tr["num_iter"] * (b["fwd_s"] + b["bwd_s"]), KERNELS)

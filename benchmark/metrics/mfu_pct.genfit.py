"""A generate+fit call's model operations (``costs/psi.py``) over the
window, against the chip's bf16 peak."""

from benchmark.costs import psi
from benchmark.readers import genfit_searches, mfu_pct


def read(ctx):
    tr = ctx.run.traffic
    cand = tr["fit"]["prune"] or ctx.run.config["scenes"]["scene_points"]
    return mfu_pct(ctx, psi.genfit_call_flops(ctx.run.config, tr["population"], tr["num_iter"],
                                              genfit_searches(tr), cand))

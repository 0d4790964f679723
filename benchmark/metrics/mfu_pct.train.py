"""A training step's model operations (``costs/psi.py``) over the window,
against the chip's bf16 peak."""

from benchmark.costs import psi
from benchmark.readers import mfu_pct


def read(ctx):
    cfg = ctx.run.config
    return mfu_pct(ctx, psi.train_step_flops(cfg, ctx.run.traffic["batch_size"], cfg["scenes"]["scene_points"]))

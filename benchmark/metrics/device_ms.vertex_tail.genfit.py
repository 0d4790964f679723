"""Device milliseconds a traced generate+fit call spends in K6, the einsum
decode's per-vertex tail (``psi_tpu_torch/csrc/vertex_tail.cu``: the 3x4
apply, the translation and the extrinsics, forward and gradient): the
kernels whose names hold ``vtail_`` (``vtail_fwd_kernel``,
``vtail_bwd_kernel``, ``vtail_reduce_kernel``). The exact tier's 'high'
decode runs it every pass; the production tier's fused skinning (K1/K2)
never does, and reads 0. Read from the device's kernels by name, the same
whether a call replays its CUDA graph or runs eagerly. A program without K6
(``psi_tpu_torch.ops.vertex_tail``) reads nothing."""

import importlib.util

from benchmark.readers import per_unit

PATTERNS = ("vtail_",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or importlib.util.find_spec("psi_tpu_torch.ops.vertex_tail") is None:
        return None
    return per_unit(ctx, 1e3 * t.device_s(PATTERNS))

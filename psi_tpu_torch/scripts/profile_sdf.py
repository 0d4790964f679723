"""SDF lookup variant shootout on the card. Port of ``scripts/profile_sdf.py``.

    python -m psi_tpu_torch.scripts.profile_sdf

Times 20 steps of p <- p + 1e-6 * d(sum sdf(p))/dp (autograd) at the fit's
shapes (256 bodies x 10475 verts, 4 scenes of 128^3 grids) for the
variants that chose the fit's lookup:

  packed_f32          sdf_trilinear_packed on the f32 corner-packed grid
  packed_bf16         the same on the bf16 corner-packed grid
  packed_unrolled     packed_f32 again: the JAX script's inline copy of the
                      lookup with an unrolled lerp is, in the port, the same
                      function, so this row shows the run-to-run spread
  stacked_8gather     sdf_trilinear_stacked: 8 scalar gathers per point
  packed_f32_fwdonly  packed_f32 forward only: p <- p + 1e-6 * sum sdf(p)

Reported in ms per step (CUDA events over 3 reps after a warm-up, each
rep on fresh points). Grids and points are made on the card from a seed.
Needs an NVIDIA card.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from psi_tpu_torch.ops.sdf import pack_sdf_corners, sdf_trilinear_packed, sdf_trilinear_stacked
from psi_tpu_torch.utils.timing import card, nvidia_smi

B, V, DIM, S = 256, 10475, 128, 4
ITERS = 20


def _steps(fn: Callable, grad: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """ITERS update steps of the points through lookup ``fn(points)``."""
    def one(points):
        p = points
        for _ in range(ITERS):
            if grad:
                q = p.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(fn(q).sum(), q)
                p = p + 1e-6 * g
            else:
                with torch.no_grad():
                    p = p + 1e-6 * fn(p).sum()
        return p
    return one


def run_variants(dev: torch.device, reps: int = 3) -> Dict[str, float]:
    """ms per step of each variant; prints one line each."""
    g = torch.Generator(device=dev).manual_seed(0)
    sdf_stack = torch.randn((S, DIM, DIM, DIM), generator=g, device=dev)
    packed = pack_sdf_corners(sdf_stack)
    packed_bf16 = packed.to(torch.bfloat16)
    grid_mins = torch.full((S, 3), -4.0, device=dev)
    grid_maxs = torch.full((S, 3), 4.0, device=dev)
    scene_idx = torch.zeros((B,), dtype=torch.int64, device=dev)
    pts = [torch.rand((B, V, 3), generator=g, device=dev) * 8.0 - 4.0 for _ in range(reps + 1)]
    bounds = (grid_mins, grid_maxs)
    variants = {
        "packed_f32": _steps(lambda p: sdf_trilinear_packed(packed, scene_idx, p, *bounds), True),
        "packed_bf16": _steps(lambda p: sdf_trilinear_packed(packed_bf16, scene_idx, p, *bounds), True),
        "packed_unrolled": _steps(lambda p: sdf_trilinear_packed(packed, scene_idx, p, *bounds), True),
        "stacked_8gather": _steps(lambda p: sdf_trilinear_stacked(sdf_stack, scene_idx, p, *bounds), True),
        "packed_f32_fwdonly": _steps(lambda p: sdf_trilinear_packed(packed, scene_idx, p, *bounds), False),
    }
    print(f"{'variant':<22} {'s/rep':>10} {'ms/iter':>10}", flush=True)
    out = {}
    for name, fn in variants.items():
        fn(pts[0])  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            p = fn(pts[1 + i])
        end.record()
        end.synchronize()
        if not torch.isfinite(p).all():
            raise AssertionError(f"{name}: points left the finite range")
        s_rep = start.elapsed_time(end) / 1e3 / reps
        out[name] = s_rep / ITERS * 1e3
        print(f"[sdf] {name:<22} {s_rep:10.4f} {out[name]:10.4f}", flush=True)
    return out


def main() -> None:
    dev = card()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {nvidia_smi()}", flush=True)
    run_variants(dev)


if __name__ == "__main__":
    main()

"""The precision the reference computes in.

A configuration states its precision: the production tier rounds the
operands of the LBS vertex path's products and the stored SDF grid to
bf16 and computes the rest in float32; the exact tier computes everything
in float32 with TF32 off. The reference follows what the configuration
states. Its control, which the correctness check has to reject, computes
one step below: fp8 (e4m3, scaled per tensor) where bf16 is stated, and
TF32 where float32 is.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FP8_MAX = 448.0  # largest finite e4m3 value


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back; the gradient passes straight through."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to e4m3 under one scale for the tensor (its largest magnitude
    maps to 448), and back; the gradient passes straight through."""
    amax = torch.clamp(t.detach().abs().amax(), min=1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()


@dataclasses.dataclass(frozen=True)
class Numerics:
    """ops: rounding of the large products' operands ("f32", "bf16", "fp8");
    grid: rounding of the stored SDF grid; tf32: TF32 for every float32
    matrix product and convolution."""

    ops: str = "f32"
    grid: str = "f32"
    tf32: bool = False

    def _round(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        if kind == "f32":
            return t
        return round_bf16(t) if kind == "bf16" else round_fp8(t)

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return self._round(self.ops, t)

    def grid_values(self, t: torch.Tensor) -> torch.Tensor:
        return self._round(self.grid, t)

    @contextlib.contextmanager
    def matmul_mode(self):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# what each configuration's tier states, and one step below it
STATED = {"production": Numerics(ops="bf16", grid="bf16"), "exact": Numerics()}
CONTROL = {"production": Numerics(ops="fp8", grid="fp8", tf32=True), "exact": Numerics(tf32=True)}

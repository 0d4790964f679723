"""Chamfer nearest-neighbour distances: kernel K3, its twin and its callers.

Port of ``psi_tpu.ops.chamfer``. One-sided (the contact term of the
training loss and of the fit loss, body -> scene only):
``chamfer_one_sided`` (differentiable in both clouds) and
``chamfer_one_sided_nn`` (differentiable in x, returns the frozen winner
for the selection-refresh carry). Two-sided (the reference's full chamfer
distance; neither loss uses the scene -> body direction):
``chamfer_distance`` (differentiable in both clouds) and
``chamfer_with_idx`` (distances and winners, no gradient); each is two
searches with the clouds swapped.

The NN search itself is ``nn_argmin``: x [B, N, 3], y [B, M, 3] -> the
index of each x point's nearest y point, ties to the lowest index.
* CUDA tensors: kernel K3 (``csrc/chamfer_nn.cu``), exact f32 (x-y)^2.
* CPU tensors: the plain twin ``nn_argmin_reference`` (brute force,
  chunked over bodies; ``argmin`` returns the first minimum).
As in psi_tpu, the search returns only the index; the distance is
recomputed in torch from the winner, so gradients flow through that
recomputation and never through the search.
"""

from __future__ import annotations

from typing import Tuple

import torch

from psi_tpu_torch.ops import _cuda

NN_ARGMIN = _cuda.Kernel(
    "chamfer_nn_argmin", "psi_nn_argmin", "psi_tpu_torch/csrc/chamfer_nn.cu",
    "psi_tpu/ops/chamfer.py:87",
)

# the twin materialises [b, n, M, 3] differences; bound each chunk to this
# many elements (256 MiB of f32)
_TWIN_CHUNK = 1 << 26


def nn_argmin_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: [B, N] int64 nearest-neighbour indices."""
    B, N, _ = x.shape
    M = y.shape[1]
    out = torch.empty((B, N), dtype=torch.int64, device=x.device)
    per_body = N * M * 3
    bstep = max(1, _TWIN_CHUNK // per_body)
    nstep = N if per_body <= _TWIN_CHUNK else max(1, _TWIN_CHUNK // (M * 3))
    for b0 in range(0, B, bstep):
        yb = y[b0 : b0 + bstep, None]
        for n0 in range(0, N, nstep):
            d = ((x[b0 : b0 + bstep, n0 : n0 + nstep, None, :] - yb) ** 2).sum(-1)
            out[b0 : b0 + bstep, n0 : n0 + nstep] = d.argmin(-1)
    return out


def nn_argmin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[B, N] int64 index of the nearest y for each x (no gradient):
    K3 on CUDA tensors, the twin on CPU tensors."""
    if x.dim() != 3 or y.dim() != 3 or x.shape[-1] != 3 or y.shape[-1] != 3 or x.shape[0] != y.shape[0]:
        raise ValueError(f"nn_argmin takes x [B, N, 3] and y [B, M, 3], got {tuple(x.shape)}, {tuple(y.shape)}")
    if y.shape[1] == 0:
        raise ValueError("nn_argmin needs a non-empty y cloud")
    x = x.detach()
    y = y.detach()
    if x.device.type == "cpu":
        return nn_argmin_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"nn_argmin runs on cpu or cuda tensors, got {x.device}")
    B, N, _ = x.shape
    M = y.shape[1]
    _cuda.check(x, "x", torch.float32, (B, N, 3), x.device)
    _cuda.check(y, "y", torch.float32, (B, M, 3), x.device)
    idx = torch.empty((B, N), dtype=torch.int64, device=x.device)  # the kernel writes int64 itself
    NN_ARGMIN.launch(x.device, x.data_ptr(), y.data_ptr(), idx.data_ptr(), B, N, M, _cuda.stream_of(x))
    return idx


def _gather_points(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y [B, M, 3], idx [B, N] -> y[b, idx[b, n]] as [B, N, 3]."""
    return torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))


def _scatter_rows(rows: torch.Tensor, idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Sum rows [B, N, 3] into zeros_like(like [B, M, 3]) at idx [B, N]. On
    the card index_add_ sums with atomics: the order of the sum, and so the
    last bit, may differ from run to run."""
    B, M, _ = like.shape
    flat = (idx + torch.arange(B, device=like.device)[:, None] * M).reshape(-1)
    return torch.zeros_like(like).reshape(B * M, 3).index_add_(0, flat, rows.reshape(-1, 3)).reshape(B, M, 3)


class _ChamferOneSided(torch.autograd.Function):
    """d1 = |x - y[i1]|^2 with the reference CUDA backward: the gradient
    scatters into both clouds (psi_tpu ``_chamfer_one_bwd``)."""

    @staticmethod
    def forward(ctx, x, y):
        i1 = nn_argmin(x, y)
        d1 = ((x - _gather_points(y, i1)) ** 2).sum(-1)
        ctx.save_for_backward(x, y, i1)
        return d1

    @staticmethod
    def backward(ctx, g1):
        x, y, i1 = ctx.saved_tensors
        diff1 = x - _gather_points(y, i1)  # [B, N, 3]
        term = 2.0 * g1[..., None] * diff1
        gy = None
        if ctx.needs_input_grad[1]:
            gy = _scatter_rows(-term, i1, y)
        return term, gy


def chamfer_one_sided(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared NN distance x -> y: [B, N, 3] x [B, M, 3] -> [B, N],
    differentiable with respect to both clouds."""
    return _ChamferOneSided.apply(x.to(torch.float32), y.to(torch.float32))


class _Chamfer(torch.autograd.Function):
    """(d1, d2) = (|x - y[i1]|^2, |y - x[i2]|^2) with the reference CUDA
    backward: each direction's gradient flows to its own point and scatters
    into the winner (psi_tpu ``_chamfer_bwd``)."""

    @staticmethod
    def forward(ctx, x, y):
        i1, i2 = nn_argmin(x, y), nn_argmin(y, x)
        d1 = ((x - _gather_points(y, i1)) ** 2).sum(-1)
        d2 = ((y - _gather_points(x, i2)) ** 2).sum(-1)
        ctx.save_for_backward(x, y, i1, i2)
        return d1, d2

    @staticmethod
    def backward(ctx, g1, g2):
        x, y, i1, i2 = ctx.saved_tensors
        t1 = 2.0 * g1[..., None] * (x - _gather_points(y, i1))  # [B, N, 3]
        t2 = 2.0 * g2[..., None] * (y - _gather_points(x, i2))  # [B, M, 3]
        gx = t1 + _scatter_rows(-t2, i2, x) if ctx.needs_input_grad[0] else None
        gy = _scatter_rows(-t1, i1, y) + t2 if ctx.needs_input_grad[1] else None
        return gx, gy


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared NN distance, differentiable with respect to both
    clouds: x [B, N, 3], y [B, M, 3] -> (dist1 [B, N], dist2 [B, M])."""
    return _Chamfer.apply(x.to(torch.float32), y.to(torch.float32))


def chamfer_with_idx(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dist1 [B, N], dist2 [B, M], idx1 [B, N], idx2 [B, M]): like
    chamfer_distance with the winners' int64 indices, no gradient."""
    x = x.detach().to(torch.float32)
    y = y.detach().to(torch.float32)
    i1, i2 = nn_argmin(x, y), nn_argmin(y, x)
    return ((x - _gather_points(y, i1)) ** 2).sum(-1), ((y - _gather_points(x, i2)) ** 2).sum(-1), i1, i2


def chamfer_one_sided_nn(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d1 [B, N], y_nn [B, N, 3]): the squared distance to the winning
    neighbour and that neighbour (detached). d1 is differentiable with
    respect to x only; y_nn is the frozen correspondence of the fit's
    selection-refresh cheap passes."""
    x = x.to(torch.float32)
    y = y.to(torch.float32).detach()
    y_nn = _gather_points(y, nn_argmin(x, y))
    return ((x - y_nn) ** 2).sum(-1), y_nn

"""Shared building blocks (port of psi_tpu.nn.layers; reference
source/net_layers.py:28-43): flax-semantics BatchNorm and Dropout, and the
residual MLP block."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from psi_tpu_torch.parallel.distributed import all_reduce_sum


class _FlaxBatchNorm:
    """Training-mode forward of a torch BatchNorm with flax's ``nn.BatchNorm``
    running statistics.

    Both normalise a training batch with its biased variance and blend the
    running statistics as (1 - momentum) * running + momentum * batch, but
    torch blends in the unbiased variance (times n / (n - 1), n the count per
    feature) and flax the biased one. psi_tpu's running statistics are
    flax's, so here the blended-in part is scaled back by (n - 1) / n.
    ``momentum`` must be a number (no cumulative average).
    Parameter and buffer names, the training-mode output and eval mode are
    torch's, unchanged.

    Over a mesh of several ranks (``use_mesh``), a training batch is the
    global one, as under psi_tpu's GSPMD: the per-feature sum, sum of squares
    and count are summed over the ranks by a differentiable all-reduce, and
    the batch is normalised with flax's statistics of the whole batch, mean
    and max(0, E[x^2] - mean^2), which the running ones blend in. The
    backward then runs through the all-reduce too (``nn.SyncBatchNorm``
    blends the unbiased variance and is not this). A mesh of one rank holds
    the whole batch and takes the path above.
    """

    mesh = None  # set by use_mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.mesh is not None and self.mesh.size > 1:
            return self._forward_global(x)
        n = x.numel() // x.shape[1]
        # torch blends momentum * unbiased into the buffer it is given: hand it
        # zeros for the variance, and blend (n - 1) / n of what comes back.
        # (Autograd keeps the buffers it was given, so running_var itself is
        # only touched after the call, and never by it.)
        new_var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, self.running_mean, new_var, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(new_var, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[1]
        dims = (0,) + tuple(range(2, x.dim()))
        local = torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), x.new_full((1,), x.numel() // C)])
        stats = all_reduce_sum(local, self.mesh)
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp(stats[C : 2 * C] / n - mean * mean, min=0.0)
        shape = (1, C) + (1,) * (x.dim() - 2)
        y = (x - mean.reshape(shape)) * (torch.rsqrt(var + self.eps) * self.weight).reshape(shape)
        out = y + self.bias.reshape(shape)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance (``_FlaxBatchNorm``)."""


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over [B, C] with flax's ``nn.BatchNorm`` defaults:
    momentum 0.99 in flax's convention (0.01 in torch's), eps 1e-5, and
    flax's running variance (``_FlaxBatchNorm``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)


def draw_rows(draw, shape, mesh) -> torch.Tensor:
    """``draw(shape)`` for a tensor of this rank's rows. Over a mesh of several
    ranks every rank draws the global batch's tensor from the same generator
    and keeps its own rows, so a sharded step sees the same noise as the
    unsharded one."""
    if mesh is None or mesh.size == 1:
        return draw(tuple(shape))
    lo, hi = mesh.rows(shape[0] * mesh.size)
    return draw((shape[0] * mesh.size,) + tuple(shape[1:]))[lo:hi]


def dropout_mask(shape, keep: float, generator: torch.Generator, device) -> torch.Tensor:
    """Bool mask of ``shape``: each entry True with probability ``keep``,
    drawn from ``generator`` (which lives on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) < keep


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training (``deterministic=False``) each unit
    is kept with probability 1 - rate and scaled by 1 / (1 - rate), else 0;
    otherwise the input is returned as it is. The mask comes from an
    explicit generator, never from torch's global state; over a mesh it is
    the global batch's (``draw_rows``)."""

    mesh = None  # set by use_mesh

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training draws its mask from an explicit torch.Generator")
        keep = 1.0 - self.rate
        mask = draw_rows(lambda s: dropout_mask(s, keep, generator, x.device), x.shape, self.mesh)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def use_mesh(model: nn.Module, mesh) -> nn.Module:
    """Make every mesh-aware module of ``model`` (one whose class declares a
    ``mesh`` attribute: the BatchNorms, ``Dropout``, VPoser's noise) work on
    the global batch over ``mesh`` (None: this rank's batch alone).
    Returns ``model``."""
    for m in model.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh
    return model


class ResBlock(nn.Module):
    """2x (Linear + LeakyReLU(0.01)) with an identity skip."""

    def __init__(self, n_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(n_dim, n_dim)
        self.fc2 = nn.Linear(n_dim, n_dim)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.fc1(x0), 0.01)
        x = F.leaky_relu(self.fc2(x), 0.01)
        return x + x0

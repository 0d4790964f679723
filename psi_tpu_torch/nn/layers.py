"""Shared MLP building blocks (port of psi_tpu.nn.layers; reference
source/net_layers.py:28-43)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from psi_tpu_torch.parallel.distributed import all_reduce_sum


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax's ``nn.BatchNorm``.

    Both normalise a training batch with its biased variance and blend the
    running statistics as (1 - momentum) * running + momentum * batch, but
    torch blends in the unbiased variance (times n / (n - 1), n = B*H*W per
    channel) and flax the biased one. psi_tpu's running statistics are
    flax's, so here the blended-in part is scaled back by (n - 1) / n.
    ``momentum`` must be a number (no cumulative average).
    Parameter and buffer names, the training-mode output and eval mode are
    ``nn.BatchNorm2d``'s, unchanged.

    Over a mesh of several ranks (``use_mesh``), a training batch is the
    global one, as under psi_tpu's GSPMD: the per-channel sum, sum of squares
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
        dims = (0, 2, 3)
        local = torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), x.new_full((1,), x.numel() // C)])
        stats = all_reduce_sum(local, self.mesh)
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp(stats[C : 2 * C] / n - mean * mean, min=0.0)
        shape = (1, C, 1, 1)
        y = (x - mean.reshape(shape)) * (torch.rsqrt(var + self.eps) * self.weight).reshape(shape)
        out = y + self.bias.reshape(shape)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return out


def use_mesh(model: nn.Module, mesh) -> nn.Module:
    """Make every ``BatchNorm2d`` of ``model`` take its training statistics
    over ``mesh`` (None: this rank's batch alone). Returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
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

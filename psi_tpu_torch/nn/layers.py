"""Shared MLP building blocks (port of psi_tpu.nn.layers; reference
source/net_layers.py:28-43)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


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
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
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

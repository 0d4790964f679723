"""Shared MLP building blocks (port of psi_tpu.nn.layers; reference
source/net_layers.py:28-43)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


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

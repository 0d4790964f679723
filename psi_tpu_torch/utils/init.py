"""Seeded weight initialisation that touches no global random state."""

from __future__ import annotations

import math

import torch
from torch import nn


def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Re-draw every Linear and Conv2d weight and bias from a
    ``torch.Generator`` seeded with ``seed``, uniform in +-1/sqrt(fan_in)
    (the bound of PyTorch's default init), and reset BatchNorm layers to
    identity statistics. Draws happen on the CPU in module order, so the
    same seed gives the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) * 2 * bound - bound)
                if m.bias is not None:
                    m.bias.copy_(torch.rand(m.bias.shape, generator=gen) * 2 * bound - bound)
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.reset_parameters()
    return module

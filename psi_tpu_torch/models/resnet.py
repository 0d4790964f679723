"""ResNet-18 trunk of the scene encoder, NCHW.

Port of ``psi_tpu.models.resnet`` (flax, NHWC): the reference's
torchvision resnet18 with a fresh 2-channel 7x7/s2 stem, truncated to
``children()[1:6]`` — bn1, relu, maxpool, layer1 (2x BasicBlock-64),
layer2 (2x BasicBlock-128, stride 2) (reference source/cvae.py:427-437).
128x128 input -> [B, 128, 16, 16] features.

The module is an ``nn.Sequential`` laid out as the reference's, so its
state-dict keys are the reference checkpoint's: resnet.0 = stem conv,
resnet.1 = bn1, resnet.4 / resnet.5 = layer1 / layer2, and inside each
block conv1, bn1, conv2, bn2, downsample.0 / downsample.1.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 conv-BN-relu, 3x3 conv-BN, skip, relu."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, features, 1, stride=stride, bias=False),
                nn.BatchNorm2d(features, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def resnet18_trunk(in_channels: int = 2) -> nn.Sequential:
    """[B, in_channels, H, W] -> [B, 128, H/8, W/8]."""
    return nn.Sequential(
        nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False),
        nn.BatchNorm2d(64, eps=1e-5),
        nn.ReLU(),
        nn.MaxPool2d(3, stride=2, padding=1),
        nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64)),
        nn.Sequential(BasicBlock(64, 128, stride=2), BasicBlock(128, 128)),
    )

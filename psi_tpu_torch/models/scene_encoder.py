"""Scene feature encoder: ResNet18 trunk -> 3x3 conv -> flatten -> Linear.

Port of ``psi_tpu.models.scene_encoder`` (reference source/cvae.py:
427-437). The public input stays psi_tpu's NHWC [B, H, W, C] snapshot;
it is permuted to NCHW for the convolutions. The flatten before ``fc`` is
NCHW (channel-major), the reference's order — psi_tpu flattens NHWC, so
weights carried across permute ``fc``'s input columns
(utils/convert_jax.py).
"""

from __future__ import annotations

import torch
from torch import nn

from psi_tpu_torch.models.resnet import resnet18_trunk
from psi_tpu_torch.utils.precision import strict_f32


class SceneEncoder(nn.Module):
    """Attributes ``resnet``, ``conv`` and ``fc`` carry the reference's
    state-dict names."""

    def __init__(self, f_dim: int = 32, num_hidden: int = 512, in_channels: int = 2, image_size: int = 128):
        super().__init__()
        spatial = image_size // 8
        self.resnet = resnet18_trunk(in_channels)
        self.conv = nn.Conv2d(128, f_dim, 3, padding=1)
        self.fc = nn.Linear(f_dim * spatial * spatial, num_hidden)

    def encode_scene(self, x_s: torch.Tensor) -> torch.Tensor:
        """x_s [B, H, W, C] (NHWC) -> [B, num_hidden]. BatchNorm follows the
        module's mode (``train()`` / ``eval()``); convolutions in full f32
        (no TF32)."""
        with strict_f32():
            feat = self.conv(self.resnet(x_s.permute(0, 3, 1, 2)))
            return self.fc(feat.flatten(1))

    def forward(self, x_s: torch.Tensor) -> torch.Tensor:
        return self.encode_scene(x_s)

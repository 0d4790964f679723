"""VPoser decoder — the 21-joint body-pose prior's latent -> axis-angle map.

Port of the decode path of ``psi_tpu.body.vposer`` (reference
human_body_prior/train/vposer_smpl.py:107-121): FC(512) + LeakyReLU(0.2)
+ FC(512) + LeakyReLU(0.2) + FC(21*6) -> 6D rotations -> matrices ->
axis-angle. The fit path only decodes, so only the decoder is ported.
Layer names are the reference checkpoint's (``bodyprior_dec_*``), so a
reference VPoser snapshot loads with ``strict=False`` (its encoder keys
are not used).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from psi_tpu_torch.geometry.rot6d import matrix_to_aa, rot6d_to_matrix
from psi_tpu_torch.utils.init import seeded_init_

NUM_VPOSER_JOINTS = 21


class VPoser(nn.Module):
    def __init__(self, num_neurons: int = 512, latentD: int = 32, num_joints: int = NUM_VPOSER_JOINTS):
        super().__init__()
        self.num_joints = num_joints
        self.bodyprior_dec_fc1 = nn.Linear(latentD, num_neurons)
        self.bodyprior_dec_fc2 = nn.Linear(num_neurons, num_neurons)
        self.bodyprior_dec_out = nn.Linear(num_neurons, num_joints * 6)

    def decode_matrot(self, z: torch.Tensor) -> torch.Tensor:
        """[B, latentD] -> [B, num_joints, 3, 3] (eval mode: no dropout)."""
        x = F.leaky_relu(self.bodyprior_dec_fc1(z), 0.2)
        x = F.leaky_relu(self.bodyprior_dec_fc2(x), 0.2)
        x6 = self.bodyprior_dec_out(x)
        return rot6d_to_matrix(x6.reshape(-1, self.num_joints, 6))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """[B, latentD] -> [B, num_joints*3] axis-angle."""
        return matrix_to_aa(self.decode_matrot(z)).reshape(z.shape[0], -1)


def vposer_decode(vposer: VPoser, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, 32] -> body-pose axis-angle [B, 63]."""
    return vposer(z)


def synthetic_vposer(seed: int = 0, num_joints: int = NUM_VPOSER_JOINTS, device="cpu") -> VPoser:
    """A VPoser decoder with seeded random weights (tests and benchmarks
    without a checkpoint). The draws are torch's, not psi_tpu's: tests
    that compare the packages carry weights across with convert_jax."""
    return seeded_init_(VPoser(num_joints=num_joints), seed).to(device).eval()

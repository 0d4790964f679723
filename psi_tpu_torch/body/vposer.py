"""VPoser — the 21-joint body-pose prior VAE.

Port of ``psi_tpu.body.vposer`` (reference
human_body_prior/train/vposer_smpl.py:49-171): encoder
BN + FC(512) + LeakyReLU(0.2) + BN + dropout 0.1 + FC(512) + LeakyReLU(0.2)
-> Normal(mu, softplus(logvar)); decoder FC(512) + LeakyReLU(0.2) + dropout
0.1 + FC(512) + LeakyReLU(0.2) + FC(21*6) -> 6D rotations -> matrices ->
axis-angle. The BatchNorms and dropouts follow flax's semantics
(``nn.layers``). Layer names are the reference checkpoint's
(``bodyprior_enc_*``, ``bodyprior_dec_*``), so a reference VPoser snapshot
loads with ``load_state_dict``.

The fit, training and serving paths only decode, through
``vposer_decode``, which runs the decoder with dropout off whatever mode the
module is in. The full VAE forward is the VPoser trainer's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from psi_tpu_torch.geometry.rot6d import matrix_to_aa, rot6d_to_matrix
from psi_tpu_torch.nn.layers import BatchNorm1d, Dropout, draw_rows
from psi_tpu_torch.utils.init import seeded_init_

NUM_VPOSER_JOINTS = 21
DROPOUT_RATE = 0.1


class VPoser(nn.Module):
    """In training mode (``train()``) the encoder's BatchNorms use the
    batch's statistics, both dropouts are on and the latent is sampled; in
    eval mode the running statistics are used, no unit is dropped and the
    latent is the mean. Random draws come from the ``generator`` passed in,
    never from torch's global state."""

    mesh = None  # set by nn.layers.use_mesh: the noise is drawn for the global batch

    def __init__(self, num_neurons: int = 512, latentD: int = 32, num_joints: int = NUM_VPOSER_JOINTS):
        super().__init__()
        self.num_joints = num_joints
        self.latentD = latentD
        # The decoder is registered first: seeded_init_ draws in module order,
        # so synthetic_vposer's decoder weights are those of the decoder-only
        # module that preceded the encoder.
        self.bodyprior_dec_fc1 = nn.Linear(latentD, num_neurons)
        self.bodyprior_dec_dropout = Dropout(DROPOUT_RATE)
        self.bodyprior_dec_fc2 = nn.Linear(num_neurons, num_neurons)
        self.bodyprior_dec_out = nn.Linear(num_neurons, num_joints * 6)
        n_features = num_joints * 3
        self.bodyprior_enc_bn1 = BatchNorm1d(n_features)
        self.bodyprior_enc_fc1 = nn.Linear(n_features, num_neurons)
        self.bodyprior_enc_bn2 = BatchNorm1d(num_neurons)
        self.bodyprior_enc_dropout = Dropout(DROPOUT_RATE)
        self.bodyprior_enc_fc2 = nn.Linear(num_neurons, num_neurons)
        self.bodyprior_enc_mu = nn.Linear(num_neurons, latentD)
        self.bodyprior_enc_logvar = nn.Linear(num_neurons, latentD)

    def encode(self, pose_aa: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, J*3] -> (mean [B, latentD], std [B, latentD])."""
        x = pose_aa.reshape(pose_aa.shape[0], -1)
        x = self.bodyprior_enc_bn1(x)
        x = F.leaky_relu(self.bodyprior_enc_fc1(x), 0.2)
        x = self.bodyprior_enc_bn2(x)
        x = self.bodyprior_enc_dropout(x, deterministic=not self.training, generator=generator)
        x = F.leaky_relu(self.bodyprior_enc_fc2(x), 0.2)
        return self.bodyprior_enc_mu(x), F.softplus(self.bodyprior_enc_logvar(x))

    def decode_matrot(self, z: torch.Tensor, deterministic: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, latentD] -> [B, num_joints, 3, 3]."""
        x = F.leaky_relu(self.bodyprior_dec_fc1(z), 0.2)
        x = self.bodyprior_dec_dropout(x, deterministic=deterministic, generator=generator)
        x = F.leaky_relu(self.bodyprior_dec_fc2(x), 0.2)
        x6 = self.bodyprior_dec_out(x)
        return rot6d_to_matrix(x6.reshape(-1, self.num_joints, 6))

    def decode_aa(self, z: torch.Tensor, deterministic: bool = True,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, latentD] -> [B, num_joints*3] axis-angle."""
        return matrix_to_aa(self.decode_matrot(z, deterministic, generator)).reshape(z.shape[0], -1)

    def forward(self, pose_aa: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The VAE on axis-angle input [B, J*3] -> dict(mean, std, pose_aa)
        (vposer_smpl.py:123-141 with output_type='aa'). z = mean + std * eps:
        in training mode eps is drawn from ``generator`` unless given; in eval
        mode eps=None means z = mean."""
        mean, std = self.encode(pose_aa, generator)
        if eps is None and self.training:
            if generator is None:
                raise ValueError("VPoser in training draws its noise from an explicit torch.Generator or takes eps")
            eps = draw_rows(lambda s: torch.randn(s, generator=generator, device=mean.device), mean.shape, self.mesh)
        z = mean if eps is None else mean + std * eps
        rec = self.decode_aa(z, deterministic=not self.training, generator=generator)
        return {"mean": mean, "std": std, "pose_aa": rec}


def vposer_decode(vposer: VPoser, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, 32] -> body-pose axis-angle [B, 63], dropout off whatever
    the module's mode (psi_tpu's ``vposer_decode``)."""
    return vposer.decode_aa(z, deterministic=True)


def synthetic_vposer(seed: int = 0, num_joints: int = NUM_VPOSER_JOINTS, device="cpu") -> VPoser:
    """A VPoser with seeded random weights (tests and benchmarks without a
    checkpoint), in eval mode. The draws are torch's, not psi_tpu's: tests
    that compare the packages carry weights across with convert_jax."""
    return seeded_init_(VPoser(num_joints=num_joints), seed).to(device).eval()

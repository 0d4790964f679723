"""Stage-1 model: one CVAE over the full 75-D body vector.

Port of ``psi_tpu.models.cvae_s1`` (reference source/cvae.py:411-534):
scene encoder (ResNet18 trunk, f_dim=32, fc -> latentD), human encoder
Linear(75 -> latentD) + 2 ResBlocks(2*latentD), a 32-D latent, decoder
Linear(32 -> latentD) + 2 ResBlocks(2*latentD) -> Linear(75).

``HumanCVAES1`` is a ``SceneEncoder`` with the body CVAE on top: the
inheritance keeps the reference's flat state-dict keys (resnet.*, conv.*,
fc.*, linear_in, human_encoder.N.fc1, ...). Sampling takes an explicit
``torch.Generator`` or explicit latents.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from psi_tpu_torch.models.scene_encoder import SceneEncoder
from psi_tpu_torch.nn.layers import ResBlock
from psi_tpu_torch.utils.precision import strict_f32


def reparam(mu: torch.Tensor, logvar: torch.Tensor, generator: Optional[torch.Generator] = None,
            eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mu + eps * exp(logvar / 2) with eps given or drawn from ``generator``
    (a generator on mu's device); mu itself with neither."""
    if eps is None:
        if generator is None:
            return mu
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + eps * torch.exp(0.5 * logvar)


def prior_draw(n: int, d: int, like: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps [n, d] when given, else standard normal draws on ``like``'s device."""
    if eps is not None:
        return eps
    return torch.randn((n, d), generator=generator, device=like.device, dtype=like.dtype)


class HumanCVAES1(SceneEncoder):
    def __init__(
        self,
        latentD: int = 256,
        n_dim_body: int = 75,
        eps_d: int = 32,
        scene_in_channels: int = 2,
        image_size: int = 128,
    ):
        super().__init__(f_dim=32, num_hidden=latentD, in_channels=scene_in_channels, image_size=image_size)
        self.latentD = latentD
        self.eps_d = eps_d
        self.linear_in = nn.Linear(n_dim_body, latentD)
        self.human_encoder = nn.ModuleList([ResBlock(2 * latentD) for _ in range(2)])
        self.mu_enc = nn.Linear(2 * latentD, eps_d)
        self.logvar_enc = nn.Linear(2 * latentD, eps_d)
        self.linear_latent = nn.Linear(eps_d, latentD)
        self.human_decoder = nn.ModuleList([ResBlock(2 * latentD) for _ in range(2)])
        self.linear_out = nn.Linear(2 * latentD, n_dim_body)

    def _decode(self, z_h: torch.Tensor, z_s: torch.Tensor) -> torch.Tensor:
        with strict_f32():
            z = torch.cat([self.linear_latent(z_h), z_s], dim=1)
            for rb in self.human_decoder:
                z = rb(z)
            return self.linear_out(z)

    def forward(
        self, x_body: torch.Tensor, x_s: torch.Tensor, generator: Optional[torch.Generator] = None,
        eps: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training-form forward: (x_rec, mu, logvar). The latent noise is
        eps [B, eps_d] when given, else a draw from ``generator``; with
        neither, the posterior mean is decoded."""
        z_s = self.encode_scene(x_s)
        with strict_f32():
            z = torch.cat([self.linear_in(x_body), z_s], dim=1)
            for rb in self.human_encoder:
                z = rb(z)
            mu, logvar = self.mu_enc(z), self.logvar_enc(z)
        return self._decode(reparam(mu, logvar, generator, eps), z_s), mu, logvar

    def sample(self, x_s: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One prior draw per snapshot x_s [B, H, W, C] (cvae.py:499-512): the
        latents [B, eps_d] are standard normals from ``generator``."""
        z_s = self.encode_scene(x_s)
        return self._decode(prior_draw(x_s.shape[0], self.eps_d, z_s, generator), z_s)

    def sample_with_eps(self, x_s: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Decode given latents eps [B, eps_d] against snapshots x_s [B, H, W, C]."""
        return self._decode(eps, self.encode_scene(x_s))

    def sample_n(self, x_s: torch.Tensor, n: int, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """n prior draws for ONE snapshot x_s [1, H, W, C]: the trunk runs
        once and its feature is broadcast over the population. eps [n,
        eps_d] replaces the draw from ``generator`` when given."""
        z_s = self.encode_scene(x_s).expand(n, -1)
        return self._decode(prior_draw(n, self.eps_d, z_s, generator, eps), z_s)

    def sample_with_feat(self, z_s: torch.Tensor, generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prior draws from precomputed scene features z_s [n, latentD]: a
        coalesced caller encodes each distinct snapshot once and gathers
        the features per population row."""
        return self._decode(prior_draw(z_s.shape[0], self.eps_d, z_s, generator, eps), z_s)

"""Stage-2 model: chained "where" (global translation) and "what" (72-D
local pose) CVAEs.

Port of ``psi_tpu.models.cvae_s2`` (reference source/net_layers.py:47-234,
source/cvae.py:341-400):

* global VAE: scene feature + Linear(3 -> nh) torso -> 2 ResBlocks(2nh) ->
  z(32); decoder Linear(nh + 32 -> 32) + 2 ResBlocks(32) -> 3.
* local VAE: scene feature + torso + Linear(72 -> nh) pose -> 2
  ResBlocks(3nh) -> z(32); decoder Linear(2nh + 32 -> 128) + 2
  ResBlocks(128) -> 72.
* HumanCVAES2 chains them: the local VAE conditions on the *reconstructed*
  translation (cvae.py:379-385); sampling chains the prior branches
  (cvae.py:390-400).

Each sub-VAE is a ``SceneEncoder`` with its own trunk, and the attribute
names are the reference checkpoint's: ``trans_vae.`` / ``pose_vae.`` +
resnet.*, conv, fc, torso_linear, pose_linear, encode.{0,1}.fc{1,2},
mean_linear, log_var_linear, decode.0, decode.{1,2}.fc{1,2}, decode.3.
Noise comes from an explicit ``torch.Generator`` (the global draw first,
then the local one) or from injected latents ``eps_g`` / ``eps_l``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from psi_tpu_torch.models.cvae_s1 import prior_draw, reparam
from psi_tpu_torch.models.scene_encoder import SceneEncoder
from psi_tpu_torch.nn.layers import ResBlock
from psi_tpu_torch.utils.precision import strict_f32


def _decoder(n_in: int, width: int, n_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(n_in, width), ResBlock(width), ResBlock(width), nn.Linear(width, n_out))


class BodyGlobalPoseVAE(SceneEncoder):
    def __init__(self, zdim: int = 32, num_hidden: int = 512, f_dim: int = 32, in_channels: int = 2,
                 image_size: int = 128):
        super().__init__(f_dim=f_dim, num_hidden=num_hidden, in_channels=in_channels, image_size=image_size)
        self.zdim = zdim
        self.torso_linear = nn.Linear(3, num_hidden)
        self.encode = nn.ModuleList([ResBlock(2 * num_hidden) for _ in range(2)])
        self.mean_linear = nn.Linear(2 * num_hidden, zdim)
        self.log_var_linear = nn.Linear(2 * num_hidden, zdim)
        self.decode = _decoder(num_hidden + zdim, f_dim, 3)

    def _decode(self, z: torch.Tensor, z_s: torch.Tensor) -> torch.Tensor:
        with strict_f32():
            return self.decode(torch.cat([z, z_s], dim=1))

    def forward(self, scene: torch.Tensor, torso: torch.Tensor, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(torso_rec [B, 3], mu, logvar); noise as ``HumanCVAES1.forward``."""
        z_s = self.encode_scene(scene)
        with strict_f32():
            f = torch.cat([z_s, self.torso_linear(torso)], dim=1)
            for rb in self.encode:
                f = rb(f)
            mu, logvar = self.mean_linear(f), self.log_var_linear(f)
        return self._decode(reparam(mu, logvar, generator, eps), z_s), mu, logvar

    def sample(self, scene: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prior branch (net_layers.py:96-106): z ~ N(0, 1) -> 3-D translation."""
        z_s = self.encode_scene(scene)
        return self._decode(prior_draw(scene.shape[0], self.zdim, z_s, generator, eps), z_s)

    def sample_n(self, scene: torch.Tensor, n: int, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """n prior draws for ONE snapshot: the trunk runs once, its feature broadcasts."""
        z_s = self.encode_scene(scene).expand(n, -1)
        return self._decode(prior_draw(n, self.zdim, z_s, generator, eps), z_s)


class BodyLocalPoseVAE(SceneEncoder):
    def __init__(self, zdim: int = 32, num_hidden: int = 512, f_dim: int = 128, in_channels: int = 2,
                 n_dim_local: int = 72, image_size: int = 128):
        super().__init__(f_dim=f_dim, num_hidden=num_hidden, in_channels=in_channels, image_size=image_size)
        self.zdim = zdim
        self.torso_linear = nn.Linear(3, num_hidden)
        self.pose_linear = nn.Linear(n_dim_local, num_hidden)
        self.encode = nn.ModuleList([ResBlock(3 * num_hidden) for _ in range(2)])
        self.mean_linear = nn.Linear(3 * num_hidden, zdim)
        self.log_var_linear = nn.Linear(3 * num_hidden, zdim)
        self.decode = _decoder(2 * num_hidden + zdim, f_dim, n_dim_local)

    def _decode(self, z: torch.Tensor, z_g: torch.Tensor, z_s: torch.Tensor) -> torch.Tensor:
        with strict_f32():
            return self.decode(torch.cat([z, z_g, z_s], dim=1))

    def forward(self, scene: torch.Tensor, torso: torch.Tensor, pose: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(pose_rec [B, n_dim_local], mu, logvar)."""
        z_s = self.encode_scene(scene)
        with strict_f32():
            z_g = self.torso_linear(torso)
            f = torch.cat([self.pose_linear(pose), z_g, z_s], dim=1)
            for rb in self.encode:
                f = rb(f)
            mu, logvar = self.mean_linear(f), self.log_var_linear(f)
        return self._decode(reparam(mu, logvar, generator, eps), z_g, z_s), mu, logvar

    def sample(self, scene: torch.Tensor, torso: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prior branch (net_layers.py:196-208)."""
        z_s = self.encode_scene(scene)
        with strict_f32():
            z_g = self.torso_linear(torso)
        return self._decode(prior_draw(scene.shape[0], self.zdim, z_s, generator, eps), z_g, z_s)

    def sample_n(self, scene: torch.Tensor, torso: torch.Tensor, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prior draws for ONE snapshot and a per-row torso [n, 3]: the trunk
        runs once and its feature broadcasts over the torso rows."""
        n = torso.shape[0]
        z_s = self.encode_scene(scene).expand(n, -1)
        with strict_f32():
            z_g = self.torso_linear(torso)
        return self._decode(prior_draw(n, self.zdim, z_s, generator, eps), z_g, z_s)


class HumanCVAES2(nn.Module):
    """Two-stage CVAE (cvae.py:341-400). n_dim_body includes the 3-D
    translation; the local part is n_dim_body - 3 (72 with 6D rotations)."""

    def __init__(self, latentD_g: int = 256, latentD_l: int = 256, n_dim_body: int = 75,
                 scene_in_channels: int = 2, image_size: int = 128):
        super().__init__()
        self.trans_vae = BodyGlobalPoseVAE(zdim=32, num_hidden=latentD_g, in_channels=scene_in_channels,
                                           image_size=image_size)
        self.pose_vae = BodyLocalPoseVAE(zdim=32, num_hidden=latentD_l, in_channels=scene_in_channels,
                                         n_dim_local=n_dim_body - 3, image_size=image_size)

    def forward(self, x_body: torch.Tensor, x_s: torch.Tensor, generator: Optional[torch.Generator] = None,
                eps_g: Optional[torch.Tensor] = None, eps_l: Optional[torch.Tensor] = None):
        """Training-form forward: (x_rec, mu_g, logvar_g, mu_l, logvar_l).
        The local VAE sees the *reconstructed* global translation
        (cvae.py:379-385)."""
        x_g_rec, mu_g, logvar_g = self.trans_vae(x_s, x_body[:, :3], generator, eps_g)
        x_l_rec, mu_l, logvar_l = self.pose_vae(x_s, x_g_rec, x_body[:, 3:], generator, eps_l)
        return torch.cat([x_g_rec, x_l_rec], dim=1), mu_g, logvar_g, mu_l, logvar_l

    def sample(self, x_s: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps_g: Optional[torch.Tensor] = None, eps_l: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chained prior sampling (cvae.py:390-400)."""
        x_g = self.trans_vae.sample(x_s, generator, eps_g)
        return torch.cat([x_g, self.pose_vae.sample(x_s, x_g, generator, eps_l)], dim=1)

    def sample_n(self, x_s: torch.Tensor, n: int, generator: Optional[torch.Generator] = None,
                 eps_g: Optional[torch.Tensor] = None, eps_l: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chained prior sampling for ONE snapshot x_s [1, H, W, C]: each
        sub-VAE's trunk runs once instead of n times."""
        x_g = self.trans_vae.sample_n(x_s, n, generator, eps_g)
        return torch.cat([x_g, self.pose_vae.sample_n(x_s, x_g, generator, eps_l)], dim=1)

    def encode_scenes(self, x_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both sub-VAEs' scene features for a snapshot stack [R, H, W, C]."""
        return self.trans_vae.encode_scene(x_s), self.pose_vae.encode_scene(x_s)

    def sample_with_feats(self, z_s_g: torch.Tensor, z_s_l: torch.Tensor,
                          generator: Optional[torch.Generator] = None, eps_g: Optional[torch.Tensor] = None,
                          eps_l: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chained prior draws from precomputed per-row scene features."""
        n = z_s_g.shape[0]
        x_g = self.trans_vae._decode(prior_draw(n, self.trans_vae.zdim, z_s_g, generator, eps_g), z_s_g)
        with strict_f32():
            z_gl = self.pose_vae.torso_linear(x_g)
        x_l = self.pose_vae._decode(prior_draw(n, self.pose_vae.zdim, z_s_l, generator, eps_l), z_gl, z_s_l)
        return torch.cat([x_g, x_l], dim=1)

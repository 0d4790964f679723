"""Individual loss terms of the PSI objective.

Port of ``psi_tpu.losses.terms`` (reference source/train_s1.py:95-207,
fitting_proxe.py:101-162): each term is a scalar function of tensors, so
the composite objectives in ``train`` and ``fit`` only weight and sum.
Where torch's derivative at a kink differs from jnp's, the term is written
so that its gradient is psi_tpu's.
"""

from __future__ import annotations

import torch

from psi_tpu_torch.ops.sdf import sdf_penetration_loss


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean |a - b|, with jnp.abs's derivative at a == b: +1 for a, -1 for b
    (torch.abs has 0 there)."""
    d = a - b
    return torch.mean(torch.where(d >= 0, d, -d))


def kl_normal_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """0.5 * mean(exp(logvar) + mu^2 - 1 - logvar)  (train_s1.py:127-128)."""
    return 0.5 * torch.mean(torch.exp(logvar) + mu**2 - 1.0 - logvar)


def vposer_reg_loss(pose_vp: torch.Tensor) -> torch.Tensor:
    """mean(z^2) on the VPoser latent slice (train_s1.py:132-133)."""
    return torch.mean(pose_vp**2)


def contact_robust_loss(contact_dist: torch.Tensor, denom_offset: float = 1.0) -> torch.Tensor:
    """mean( sqrt(d + 1e-4) / (sqrt(d + 1e-4) + denom_offset) ): the robust
    saturating contact distance. denom_offset is 1.0 in training
    (train_s1.py:175-177) and 0.01 in PROX-E fitting (fitting_proxe.py:139)."""
    s = torch.sqrt(contact_dist + 1e-4)
    return torch.mean(s / (s + denom_offset))


def collision_loss(body_sdf: torch.Tensor, mesh=None) -> torch.Tensor:
    """mean |sdf| over penetrating vertices, 0 when none (train_s1.py:193-198);
    with a mesh, this rank's share of the whole batch's mean
    (``sdf_penetration_loss``)."""
    return sdf_penetration_loss(body_sdf, mesh)

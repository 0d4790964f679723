"""Generation: sample a body population for one scene snapshot.

Port of ``psi_tpu.gen.sample.generate_bodies``: encode the snapshot once,
broadcast the feature over the population, sample the CVAE prior, convert
6D -> axis-angle and recover the metric global translation.
"""

from __future__ import annotations

from typing import Optional

import torch

from psi_tpu_torch.geometry.bodyvec import convert_to_3D_rot
from psi_tpu_torch.geometry.camera import recover_global_T
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1


@torch.no_grad()
def generate_bodies(
    model: HumanCVAES1,
    xs: torch.Tensor,  # [1, H, W, 2] snapshot
    cam_int: torch.Tensor,  # [1, 3, 3]
    max_d: torch.Tensor,  # [1]
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,  # [n_samples, eps_d], replaces the draw
) -> torch.Tensor:
    """[n_samples, 72] metric body vectors. The latents come from
    ``generator`` (a generator on the model's device) unless ``eps`` is
    given."""
    xhnr = model.sample_n(xs, n_samples, generator=generator, eps=eps)
    xhn = convert_to_3D_rot(xhnr)
    cam_int_n = cam_int.reshape(1, 3, 3).expand(n_samples, 3, 3)
    max_d_n = max_d.reshape(1).expand(n_samples)
    return recover_global_T(xhn, cam_int_n, max_d_n)

"""The canonical 72/75-D body parameter vector: layout and codecs.

Port of ``psi_tpu.geometry.bodyvec`` (reference source/cvae.py:117-137,
217-249). Layout of the 72-D vector:
    [0:3]   transl          global translation (camera frame)
    [3:6]   global_orient   axis-angle global rotation
    [6:16]  betas           SMPL-X shape coefficients
    [16:48] body_pose_vp    VPoser 32-D latent
    [48:60] left_hand_pose  12 PCA coefficients
    [60:72] right_hand_pose 12 PCA coefficients
The 75-D variant holds the 6D rotation at [3:9]; the rest shifts by +3.
"""

from __future__ import annotations

from typing import Dict

import torch

from psi_tpu_torch.geometry.rot6d import aa_to_rot6d, rot6d_to_aa

BODY72_LAYOUT: Dict[str, tuple] = {
    "transl": (0, 3),
    "global_orient": (3, 6),
    "betas": (6, 16),
    "body_pose_vp": (16, 48),
    "left_hand_pose": (48, 60),
    "right_hand_pose": (60, 72),
}


def convert_to_6D_rot(x: torch.Tensor) -> torch.Tensor:
    """72-D body vector (axis-angle at [3:6]) -> 75-D (6D rotation at [3:9])."""
    return torch.cat([x[..., :3], aa_to_rot6d(x[..., 3:6]), x[..., 6:]], dim=-1)


def convert_to_3D_rot(x: torch.Tensor) -> torch.Tensor:
    """75-D body vector (6D rotation at [3:9]) -> 72-D (axis-angle at [3:6])."""
    return torch.cat([x[..., :3], rot6d_to_aa(x[..., 3:9]), x[..., 9:]], dim=-1)


def body_params_encapsulate(x72: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split a [B, 72] body vector into the named SMPL-X kwargs (views)."""
    return {k: x72[..., a:b] for k, (a, b) in BODY72_LAYOUT.items()}

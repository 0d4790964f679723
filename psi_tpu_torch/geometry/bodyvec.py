"""The canonical 72/75-D body parameter vector: layout and codecs.

Port of ``psi_tpu.geometry.bodyvec`` (reference source/cvae.py:117-137,
217-301). Layout of the 72-D vector:
    [0:3]   transl          global translation (camera frame)
    [3:6]   global_orient   axis-angle global rotation
    [6:16]  betas           SMPL-X shape coefficients
    [16:48] body_pose_vp    VPoser 32-D latent
    [48:60] left_hand_pose  12 PCA coefficients
    [60:72] right_hand_pose 12 PCA coefficients
The 75-D variant holds the 6D rotation at [3:9]; the rest shifts by +3.

The list codecs (``body_params_encapsulate_list``, ``..._latent``) are the
pickle layout of the reference's ``body_gen_*.pkl`` files: numpy in, numpy
out, one dict per body with [1, k] rows and the key ``body_pose`` for the
32-D latent. No tensor reaches a pickle.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
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


def body_params_parse(params: Dict[str, "np.ndarray | torch.Tensor"]) -> torch.Tensor:
    """Concatenate a SMPL-X kwargs dict back into the [B, 72] body vector
    (float32; reference source/cvae.py:273-301). The reference's pickle key
    ``body_pose`` is accepted for the VPoser latent slot ``body_pose_vp``."""

    def get(k):
        v = params["body_pose"] if k == "body_pose_vp" and k not in params else params[k]
        if torch.is_tensor(v):
            return v.to(torch.float32)
        return torch.from_numpy(np.array(v, dtype=np.float32))

    return torch.cat([get(k) for k in BODY72_LAYOUT], dim=-1)


def body_params_encapsulate_list(x72: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """Per-body list of numpy dicts for pickling (reference
    source/cvae.py:219-235): [1, k] rows, the latent under ``body_pose``."""
    x = np.asarray(x72)
    out = []
    for b in range(x.shape[0]):
        row = x[b : b + 1]
        out.append({("body_pose" if k == "body_pose_vp" else k): row[:, a:z] for k, (a, z) in BODY72_LAYOUT.items()})
    return out


def body_params_encapsulate_latent(x72: np.ndarray, eps: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """``body_params_encapsulate_list`` with each body's latent code [1, zdim]
    under ``z`` (reference source/cvae.py:251-271)."""
    eps_np = np.asarray(eps)
    if eps_np.shape[0] != np.asarray(x72).shape[0]:
        raise ValueError(f"eps batch {eps_np.shape[0]} != body batch {np.asarray(x72).shape[0]}")
    out = body_params_encapsulate_list(x72)
    for b, d in enumerate(out):
        d["z"] = eps_np[b : b + 1, :]
    return out

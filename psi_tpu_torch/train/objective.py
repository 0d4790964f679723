"""The scene-asset bundle the fit objective reads.

Port of ``psi_tpu.train.objective.SceneAssets``. Everything a fit call
needs lives on one device: the body model, the VPoser decoder, the
contact-vertex ids, every scene's corner-packed SDF grid and bounds, and
every scene's Morton-ordered, far-padded point cloud; bodies index their
scene with an int scene id. (The training objective itself is not
ported yet.)
"""

from __future__ import annotations

import dataclasses

import torch

from psi_tpu_torch.body.smplx_model import SMPLXModel
from psi_tpu_torch.body.vposer import VPoser


@dataclasses.dataclass(frozen=True)
class SceneAssets:
    smplx: SMPLXModel
    vposer: VPoser
    contact_vids: torch.Tensor  # [C] int64 contact-vertex ids
    sdf_packed: torch.Tensor  # [S, D, H, W, 8] corner-packed (ops.sdf.pack_sdf_corners)
    grid_mins: torch.Tensor  # [S, 3]
    grid_maxs: torch.Tensor  # [S, 3]
    scene_verts: torch.Tensor  # [S, P, 3] (far-padded)

"""Physical plausibility: non-collision and contact scores.

Port of ``psi_tpu.eval.collision`` (the protocol of the reference's
utils_eval_collision_habitat.py:121-140): per body, decode the SMPL-X
mesh at the 'high' tier (f32, TF32 off), look every vertex up in its
scene's packed SDF; non-collision = the fraction of vertices with
sdf > 0, contact = 1 if any vertex has sdf < 0. Scores are means over
the population, computed on the device of the assets.
"""

from __future__ import annotations

from typing import Tuple

import torch

from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.ops.sdf import sdf_trilinear_packed
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.precision import strict_f32


@torch.no_grad()
def collision_contact_scores(assets: SceneAssets, x72, cam_ext, scene_idx) -> Tuple[float, float]:
    """(mean non-collision score, mean contact score) of bodies x72 [N, 72]
    placed by cam_ext [N, 4, 4] in scenes scene_idx [N] (tensors or numpy
    arrays; moved to the assets' device)."""
    dev = assets.grid_mins.device
    x72 = torch.as_tensor(x72, dtype=torch.float32, device=dev)
    cam_ext = torch.as_tensor(cam_ext, dtype=torch.float32, device=dev)
    scene_idx = torch.as_tensor(scene_idx, device=dev).long()
    with strict_f32():
        verts, _ = body_vec_to_verts(assets.smplx, assets.vposer, x72, cam_ext, precision="high")
        sdf = sdf_trilinear_packed(assets.sdf_packed, scene_idx, verts, assets.grid_mins, assets.grid_maxs)
    non_collision = (sdf > 0).to(torch.float32).mean(dim=1)  # [N]
    contact = ((sdf < 0).sum(dim=1) > 0).to(torch.float32)  # [N]
    return non_collision.mean().item(), contact.mean().item()

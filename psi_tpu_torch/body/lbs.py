"""Linear blend skinning.

Port of ``psi_tpu.body.lbs`` (reference human_body_prior/body_model/
lbs.py:34-261): shape blendshapes -> joint regression -> Rodrigues ->
pose-corrective blendshapes -> kinematic-tree rigid transform ->
skinning. The kinematic tree composes all joints of one depth level in
one batched matmul (SMPL-X is about ten levels deep).

Precision tiers, psi_tpu's:
* 'high' — the two large contractions, the pose correctives and the
  skinning blend, are split-bf16 products (``ops.precision``: about
  2^-16 relative, ~16-bit mantissas, sub-0.1 mm at metre scale), kernels
  K4 and K5 on the card; the rest is float32. Callers run it under
  ``utils.precision.strict_f32`` so that no other matmul drops to TF32.
  Its gradients carry bf16-rounded cotangents, as psi_tpu's do.
* 'fast' — the three large contractions (joint regression, pose
  correctives, skinning blend) take bf16-rounded operands with float32
  accumulation, the numerics of psi_tpu's 'fast' tier on the TPU.
``exact=True`` takes every contraction to plain float32 on either tier.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from psi_tpu_torch.geometry.rot6d import aa_to_matrix
from psi_tpu_torch.ops.precision import einsum_f32x3, matmul_f32x3

PRECISIONS = ("high", "fast")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: a product of two such values is exact in
    f32, so an f32 matmul of rounded operands is a bf16 matmul with f32
    accumulation. The gradient passes straight through the rounding."""
    return t.to(torch.bfloat16).to(t.dtype)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """betas [B, L], shape_disps [V, 3, L] -> displacement [B, V, 3]."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """J_regressor [J, V], vertices [B, V, 3] -> joints [B, J, 3]."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def batch_rigid_transform(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose per-joint rotations down the kinematic tree.

    rot_mats [B, J, 3, 3]; joints [B, J, 3] rest positions; parents a
    tuple with parents[0] == -1. Returns (posed_joints [B, J, 3],
    rel_transforms [B, J, 4, 4]), the skinning transforms relative to the
    rest pose.
    """
    B, J = joints.shape[:2]
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, list(parents[1:])]], dim=1)
    pad_row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=joints.dtype, device=joints.device)
    local = torch.cat(
        [torch.cat([rot_mats, rel[..., None]], dim=-1), pad_row.expand(B, J, 1, 4)], dim=-2
    )  # [B, J, 4, 4]

    depth = [0] * J
    for j in range(1, J):
        depth[j] = depth[parents[j]] + 1
    world = [None] * J
    world[0] = local[:, 0]
    for lvl in range(1, max(depth) + 1):
        ids = [j for j in range(J) if depth[j] == lvl]
        par = torch.stack([world[parents[j]] for j in ids], dim=1)  # [B, n, 4, 4]
        comp = torch.matmul(par, local[:, ids])
        for k, j in enumerate(ids):
            world[j] = comp[:, k]
    transforms = torch.stack(world, dim=1)  # [B, J, 4, 4]

    posed_joints = transforms[:, :, :3, 3]
    # subtract the transform of the rest joint so the transform maps rest -> posed
    rot_j = torch.einsum("bjxy,bjy->bjx", transforms[:, :, :3, :3], joints)
    top = torch.cat([transforms[:, :, :3, :3], (posed_joints - rot_j)[..., None]], dim=-1)
    rel_transforms = torch.cat([top, transforms[:, :, 3:, :]], dim=-2)
    return posed_joints, rel_transforms


def joint_regressor_direct(
    J_regressor: torch.Tensor, v_template: torch.Tensor, shapedirs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the joint regression through the shape blend (it is linear in
    betas): returns (j_template [J, 3], j_shapedirs [J, 3, L])."""
    j_template = torch.einsum("jv,vk->jk", J_regressor, v_template)
    j_shapedirs = torch.einsum("jv,vkl->jkl", J_regressor, shapedirs)
    return j_template, j_shapedirs


def lbs(
    betas: torch.Tensor,
    pose_aa: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: Optional[torch.Tensor],
    J_regressor: torch.Tensor,
    parents: Tuple[int, ...],
    lbs_weights: torch.Tensor,
    exact: bool = False,
    precision: str = "high",
    joints_direct: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full LBS forward -> (verts [B, V, 3], joints [B, J, 3]).

    betas [B, L]; pose_aa [B, J*3] (joint 0 = global orient); v_template
    [V, 3]; shapedirs [V, 3, L]; posedirs [(J-1)*9, V*3] or None;
    J_regressor [J, V]; lbs_weights [V, J]. exact: plain f32 for every
    contraction, whatever ``precision`` says. joints_direct: the (j_template,
    j_shapedirs) pair of ``joint_regressor_direct``; the joints then come
    from betas directly, in f32 on every tier. Required when the per-vertex
    tensors are a vertex subset of the model (J_regressor is then unused).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"lbs precision must be one of {PRECISIONS}, got {precision!r}")
    fast = precision == "fast" and not exact
    B = betas.shape[0]
    J = len(parents)

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    if joints_direct is not None:
        j_template, j_shapedirs = joints_direct
        joints = j_template[None] + blend_shapes(betas, j_shapedirs)
    elif fast:
        joints = vertices2joints(_bf16(J_regressor), _bf16(v_shaped))
    else:
        joints = vertices2joints(J_regressor, v_shaped)

    rot_mats = aa_to_matrix(pose_aa.reshape(B, J, 3))  # [B, J, 3, 3]

    if posedirs is not None:
        ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # [B, (J-1)*9]
        if exact:
            pose_offsets = torch.matmul(pose_feature, posedirs)
        elif fast:
            pose_offsets = torch.matmul(_bf16(pose_feature), _bf16(posedirs))
        else:
            pose_offsets = matmul_f32x3(pose_feature, posedirs)
        v_posed = v_shaped + pose_offsets.reshape(B, -1, 3)
    else:
        v_posed = v_shaped

    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)

    # only the top 3x4 of each transform varies: blend 12 values, not 16
    A12 = A[:, :, :3, :].reshape(B, J, 12)
    if exact:
        T = torch.einsum("vj,bjz->bvz", lbs_weights, A12)
    elif fast:
        T = torch.einsum("vj,bjz->bvz", _bf16(lbs_weights), _bf16(A12))
    else:
        T = einsum_f32x3("vj,bjz->bvz", lbs_weights, A12, a_axis=1, b_axis=1)
    T34 = T.reshape(B, -1, 3, 4)
    verts = torch.einsum("bvxy,bvy->bvx", T34[..., :3], v_posed) + T34[..., 3]
    return verts, posed_joints

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
On every tier the per-vertex tail (the blended 3x4 applied to each vertex,
then the body's translation and the camera extrinsics when given) is
``ops.vertex_tail``: float32, kernel K6 on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from psi_tpu_torch.geometry.camera import verts_transform
from psi_tpu_torch.geometry.rot6d import aa_to_matrix
from psi_tpu_torch.ops.precision import einsum_f32x3, matmul_f32x3
from psi_tpu_torch.ops.vertex_tail import vertex_tail

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


# (parents, dtype, device) -> the kinematic tree's constant operands on that device
_TREE_OPERANDS: Dict[tuple, tuple] = {}


def _tree_operands(parents: Tuple[int, ...], dtype: torch.dtype, device: torch.device):
    """(parents[1:] as an index tensor, [(joint ids, their index tensor)] one
    depth level after another, the homogeneous row [0, 0, 0, 1]), all on
    ``device``, made at the first call for a tree, dtype and device and kept:
    later calls copy nothing from the host, so a CUDA graph can capture them."""
    key = (tuple(parents), dtype, device)
    hit = _TREE_OPERANDS.get(key)
    if hit is None:
        J = len(parents)
        depth = [0] * J
        for j in range(1, J):
            depth[j] = depth[parents[j]] + 1
        levels = []
        for lvl in range(1, max(depth) + 1):
            ids = [j for j in range(J) if depth[j] == lvl]
            levels.append((ids, torch.tensor(ids, dtype=torch.int64, device=device)))
        hit = _TREE_OPERANDS[key] = (
            torch.tensor(parents[1:], dtype=torch.int64, device=device),
            levels,
            torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device),
        )
    return hit


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
    parent_ids, levels, pad_row = _tree_operands(parents, joints.dtype, joints.device)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent_ids]], dim=1)
    local = torch.cat(
        [torch.cat([rot_mats, rel[..., None]], dim=-1), pad_row.expand(B, J, 1, 4)], dim=-2
    )  # [B, J, 4, 4]

    world = [None] * J
    world[0] = local[:, 0]
    for ids, ids_dev in levels:
        par = torch.stack([world[parents[j]] for j in ids], dim=1)  # [B, n, 4, 4]
        comp = torch.matmul(par, local[:, ids_dev])
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
    transl: Optional[torch.Tensor] = None,
    cam_ext: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full LBS forward -> (verts [B, V, 3], joints [B, J, 3]).

    betas [B, L]; pose_aa [B, J*3] (joint 0 = global orient); v_template
    [V, 3]; shapedirs [V, 3, L]; posedirs [(J-1)*9, V*3] or None;
    J_regressor [J, V]; lbs_weights [V, J]. exact: plain f32 for every
    contraction, whatever ``precision`` says.
    transl [B, 3], cam_ext [B, 4, 4] (no gradient): when given, verts and
    joints are moved by transl, then through the extrinsics
    (``verts_transform``); the verts in the same pass as the skinning apply.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"lbs precision must be one of {PRECISIONS}, got {precision!r}")
    fast = precision == "fast" and not exact
    B = betas.shape[0]
    J = len(parents)

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    if fast:
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
    if T.is_cuda:  # K6 takes contiguous operands: the 'fast' and exact blends lay T out [V, B, 12]
        T, v_posed = T.contiguous(), v_posed.contiguous()
        transl = None if transl is None else transl.contiguous()
        cam_ext = None if cam_ext is None else cam_ext.contiguous()
    verts = vertex_tail(T, v_posed, transl, cam_ext)
    if transl is not None:
        posed_joints = posed_joints + transl[:, None, :]
    if cam_ext is not None:
        posed_joints = verts_transform(posed_joints, cam_ext)
    return verts, posed_joints

"""Body vector -> mesh: the decode every fit-loss evaluation runs.

Port of ``psi_tpu.body.decode``: split the 72-D vector, decode the VPoser
latent to the 63-D body pose, run SMPL-X, apply the camera extrinsics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from psi_tpu_torch.body.smplx_model import SMPLXModel, smplx_forward, smplx_forward_fused
from psi_tpu_torch.body.vposer import VPoser, vposer_decode
from psi_tpu_torch.geometry.bodyvec import body_params_encapsulate
from psi_tpu_torch.geometry.camera import verts_transform
from psi_tpu_torch.ops.fused_skinning import SkinningBundle


def body_vec_to_verts(
    smplx: SMPLXModel,
    vposer: VPoser,
    x72: torch.Tensor,
    cam_ext: Optional[torch.Tensor] = None,
    precision: str = "high",
    joints_direct: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    fused_bundle: Optional[SkinningBundle] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x72 [B, 72] -> (verts [B, V, 3], joints [B, J, 3]).

    precision: 'high' (einsum LBS, its two large products split-bf16),
    'fast' (bf16-operand einsum LBS)
    or 'fused' (the fused skinning kernel, at the 'fast' tier, with
    transl and camera folded in). fused_bundle: precomputed
    ``make_fused_bundle(smplx)``; pass it inside an optimisation loop.
    joints_direct: required when ``smplx`` is a ``smplx_vertex_subset``
    model. Such a model falls back from 'fused' to 'fast' (the bf16-operand
    einsums; no bundle is built for a subset).
    """
    p = body_params_encapsulate(x72)
    pose_aa = vposer_decode(vposer, p["body_pose_vp"])
    if precision == "fused" and joints_direct is not None:
        precision = "fast"
    if precision == "fused":
        return smplx_forward_fused(
            smplx,
            transl=p["transl"],
            global_orient=p["global_orient"],
            betas=p["betas"],
            body_pose=pose_aa,
            left_hand_pose=p["left_hand_pose"],
            right_hand_pose=p["right_hand_pose"],
            cam_ext=cam_ext,
            bundle=fused_bundle,
        )
    verts, joints = smplx_forward(
        smplx,
        transl=p["transl"],
        global_orient=p["global_orient"],
        betas=p["betas"],
        body_pose=pose_aa,
        left_hand_pose=p["left_hand_pose"],
        right_hand_pose=p["right_hand_pose"],
        precision=precision,
        joints_direct=joints_direct,
    )
    if cam_ext is not None:
        verts = verts_transform(verts, cam_ext)
        joints = verts_transform(joints, cam_ext)
    return verts, joints
